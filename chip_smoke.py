"""Drive the PyTorch/H100 port on one NVIDIA card, end to end.

    python3 chip_smoke.py            # every phase, as the check runs it
    python3 chip_smoke.py --only kernels
    python3 chip_smoke.py --only resnet   # card, build, kernels, resnet,
                                          # resnet_train
    python3 chip_smoke.py --only graphs   # card, build, graphs
    python3 chip_smoke.py --only paged    # card, build, paged
    python3 chip_smoke.py --only chaos    # card, build, chaos
    python3 chip_smoke.py --only fleet    # card, build, fleet
    python3 chip_smoke.py --only mln      # card, build, mln
    python3 chip_smoke.py --only rnn      # card, build, rnn
    python3 chip_smoke.py --only zoo      # card, build, zoo
    python3 chip_smoke.py --only layers   # card, build, layers
    python3 chip_smoke.py --only resilience  # card, build, resilience
    python3 chip_smoke.py --only quant    # card, build, quant
    python3 chip_smoke.py --only parallel  # card, build, parallel
    python3 chip_smoke.py --only multihost  # card, build, multihost
    python3 chip_smoke.py --only keras    # card, build, keras
    python3 chip_smoke.py --only samediff  # card, build, samediff
    python3 chip_smoke.py --only onnx     # card, build, onnx
    python3 chip_smoke.py --only spark    # card, build, spark
    python3 chip_smoke.py --only arbiter  # card, build, spark's batches,
                                          # arbiter
    python3 chip_smoke.py --only clustering  # card, build, clustering
    python3 chip_smoke.py --only nlp      # card, build, nlp
    python3 chip_smoke.py --only rl       # card, build, rl
    python3 chip_smoke.py --only examples  # card, build, examples
    python3 chip_smoke.py --profile  # and phase 14

Phases, in order; any failure exits non-zero and prints no result:

1. card:    the `nvidia-smi` name and power limit.
2. build:   compile every kernel source (one nvcc each, in parallel).
3. kernels: each kernel against its plain PyTorch version on the card, at
            the main paths' shapes, in f32 and bf16, with its time, the
            plain version's time, one PyTorch library call's time (a
            yardstick only; the port never calls it) and the least time
            the card could take for the same work. The backward pair and
            the decode kernel are also re-run and must agree bit for bit
            (each decode call is one launch, its cluster size logged);
            the int8 epilogue's int32 sums must be exact at four shapes
            (its tile logged); the bottleneck block runs ResNet-50's four
            identity stages, re-run for bit identity, its plan (R rows a
            block, P pixels, blocks, L2 weight bytes) logged.
            bn_conv_grads also runs the 15
            shapes of a ResNet-50 training step's 36 conv1x1+BN pairs
            (`step36`): kernel and library ms summed over the pairs
            beside the step's bound. The four pair kernels also run the
            zoo phase's pair shapes (InceptionResNetV1's three in f32 and
            bf16, NASNet's N = 44 in bf16). matmul_epilogue and matmul_stats run
            the same 15 shapes (the 36 pairs of one ResNet-50 forward,
            `fwd36`) in f32 and bf16, summed the same way beside the sum of
            their bounds on the tensor-core route. `bert_step12` sums the BERT
            fine-tune step's 12 layers of flash_fwd, flash_bwd_dq and
            flash_bwd_dkv against 12 SDPA forwards and backwards.
4. encoder: `bert_classify` at `bert_base()` width through the kernels,
            against `attn_impl="dense"` on the card.
5. serving: `GenerationServer(BertDecoder(bert_base(), params))` answers
            12 mixed requests with a cache-rung growth; its greedy streams
            must equal a second server's built with `attn_impl="dense"`.
6. train:   `bert_base()` fine-tuning as bench.py builds it (B=32, T=128,
            ragged padding, dropout 0.1, `classification_loss`, backward,
            Adam 2e-5): 2 warm-up and 10 timed steps, each launching
            flash_fwd, flash_bwd_dq and flash_bwd_dkv 12 times; one
            step's gradients through the kernels against
            `attn_impl="dense"`; and 10 steps on one batch whose loss
            must fall.
7. resnet:  `ResNet50()` at 224×224×3, 1000 classes, f32, built once
            with the conv1x1+BN fusion on and once with it off, from one
            seed, with BN statistics and γ/β drawn from a seeded
            generator. ≥ 96 images, as requests of 1–8 rows from 8
            threads, through `ParallelInference(BATCHED, batchLimit=32)`
            over the fused net: every answer must equal the unfused net's
            output for the same rows, each forward must launch
            matmul_epilogue exactly 36 times; the avgpool features of the
            two nets must agree; one B=32 forward timed fused and unfused;
            and `bottleneck_block`, on res4_1's folded weights and the
            fused net's res4_0_relu activation, must give its res4_1_relu.
8. resnet_train: `ResNet50()` at 224×224×3, 1000 classes, f32, fused and
            unfused from one seed, trained through `ComputationGraph.fit`
            with the zoo's Nesterovs at a rate of 0.01. One step on one
            seeded batch of 32 in both nets and in the unfused net in f64:
            each gradient of the fused net must be as close to the f64
            one as the unfused f32 net's (RESNET_GRAD_FACTOR), and the new
            BN running statistics must equal the unfused net's. Then 2
            warm-up and 10 timed fused steps on that
            batch, each launching matmul_stats, bn_grad_stats and
            bn_conv_grads 36 times; the loss must fall.
9. graphs:  the executable store's three capture targets, each against
            its eager run in turns (eager, graph, graph, eager):
            BERT serving as in phase 5 (every stream equal to the eager
            server's, greedy and sampled; a second store on the same
            directory warms with every key `from_disk` and no nvcc run);
            ResNet-50 training at B=32 (parameters, optimizer and BN state
            and loss bit-identical to eager steps after 3 steps, with
            cuDNN's deterministic algorithms; 10 timed steps per arm, each
            of eager and graph with prefetch 0 and 2, in mirrored turns);
            ResNet-50 through `ParallelInference` with
            `bucketLadder([1, 2, 4, 8, 16, 32])` (each bucket's replay
            bit-identical to the eager forward of its rows, the 96 images
            equal to `net.output`, one B=32 forward timed both ways, and a
            store given no signature warming every bucket from the
            manifest). No capture after warmup, no eager call or
            degradation in a graph store, and launch counters that count
            replays.
10. paged: `bert_base()` served from a page pool (`page_size=16`,
            `pool_pages=129`: half the dense worst case) with phase 5's
            knobs, on 12 requests of which six share a 64-token system
            prompt and two are identical (one growth to rung 512). Six
            servers in turns, each through its graphs: dense fp (the
            control), paged fp, dense int8, paged int8, paged fp with
            `draft=2`, dense fp again. Gates: paged fp streams equal the
            dense fp ones and paged int8 the dense int8 ones (all, greedy
            and sampled); the drafted greedy streams equal the undrafted
            ones with drafts accepted; the paged pool counts >= 5 prefix
            hits, >= 1 copy-on-write and no page mapped at the end;
            flash_fwd and flash_decode launch in the paged fp run; every
            store serves with no live capture, eager call or degradation;
            each server fetches once per block plus once per admission. A
            pool of 3 pages refuses a 3-page prompt with
            `PagePoolExhaustedError` and then serves a 1-page one. Printed,
            not gated: tokens/s and per-token p50/p99 of each server; the
            int8 decode's logit error against fp over 16 steps; the pool's
            bytes against the dense caches'; the card time of the page
            gather, the int8 and the multi-query attention beside
            flash_decode.
11. chaos:  phase 5's server (graphed, f32) and 12 requests under injected
            faults. Fault-free first, monitoring off, on, on, off in
            turns, twice (tokens/s each; every run's streams equal).
            Then:
            two block kills (`generation.superstep`) and one admission
            kill (`generation.admit`): streams equal the fault-free run's,
            the replay modes, the ms from each fault to the next
            delivered token, the largest |Δlogit| between the decode
            path and the replay's prefill at each prefix replay point,
            flash_fwd and flash_decode launched; a `cache.page` kill on
            the paged server (streams equal, no page mapped at the end);
            an OOM-shaped fault at the growth to rung 512 (that request
            refused with `MemoryPressureError`, the rest served, relief
            back to serving); `memory_high_water` just under the
            `mem_get_info` reading after the warm-up (growth refused by
            the telemetry); and a restart budget that runs out
            (`ServerDeadError`, every consumer released within 1 s). No
            capture, rebind, degradation or eager call after a warm-up;
            every fetch a block, an admission or a replay. One JSON line
            per case.
12. fleet:  three replicas of phase 5's server (graphed, f32) behind a
            `FleetRouter` on the one card, over one parameter set and one
            manifest directory; a factory builds them and every
            replacement. 24 requests (phase 5's twice). In turns single
            server, fleet, fleet, single server: every fleet stream equals
            the single server's (greedy and sampled), each replica reads
            `_fault_free` and was routed a request; during the first fleet
            run a `UIServer` on an ephemeral port answers 200 with a
            parseable body on /fleet, /health, /generation, /metrics,
            /events, /incidents, /requests and /executables. A replica
            killed mid-stream (its block fault): streams equal, no client
            error, a failover, one replacement that warms from the
            manifest (`compiled` 0) while the survivors serve, no live
            capture or eager call in any replica, the incident ordered
            replica.unhealthy -> drained -> replaced and resolved, and
            `memory_allocated` after the replacement within 10 % of its
            value before the kill. Every 5th `router.dispatch` faulting:
            streams equal, each fault absorbed. A failing replacement
            (`replica.restart`): the fleet serves on degraded (/health
            200 degraded), and `FleetDeadError` latches (/health 503) only
            once its last replica is killed. Printed: tokens/s of each
            turn, requests routed per replica, ms from the fault to each
            failed-over request's next token, the replacement's warm-up
            seconds and the survivors' tokens/s meanwhile, allocated
            bytes before the kill, at the replacement's build and after.
13. mln:    MultiLayerNetwork on the card. The LeNet MNIST drive
            (`MnistDataSetIterator(64, num_examples=384)`, Adam(1e-2), 3
            epochs, graphed and prefetched): `evaluate` accuracy above
            0.85, one capture and no degradation; `stepsPerDispatch=3`
            equal to the sequential fit bit for bit. On LeNet in graphs,
            with cuDNN's deterministic algorithms: a StepSchedule whose
            boundary falls inside a graphed fit equals the eager fit bit
            for bit; `gradientAccumulation(4)` (two graphed updates) equals
            the explicit accumulation loop; a MaxNorm-constrained layer's
            unit norms hold after every graphed step. VGG16 at full width
            (224×224×3, 1000 classes, 138,357,544 parameters, the zoo's
            Nesterovs(1e-2, 0.9), dropout 0.5 on fc6 and fc7), one seeded
            batch of 32: 3 graphed steps equal 3 eager steps bit for bit
            (parameters, optimizer and BN state, loss; deterministic
            cuDNN) with one capture, 2 replays and no degradation or eager
            call (dropout inside the graph); then eager, graph, graph,
            eager arms of 10 timed `fit` steps after 2 warm-up steps
            (ms/step, images/s, peak allocated bytes). Served: one B=32
            `output()` timed, and phase 7's 96 images from 8 threads
            through `ParallelInference` with `bucketLadder([1, 2, 4, 8,
            16, 32])` (images/s; every answer equal to `output()` of the
            same rows to 1e-4 of the largest; no capture after warmup).
            VGG16 as a chain ComputationGraph on the network's
            parameters: one output and one training step bit-identical.
            None of the nine kernels launches on this path (counted and
            checked zero). With --profile: 3 VGG16 steps eager and graph
            and one B=32 forward under torch.profiler.
14. profile (only with --profile): the serving workload, one fused B=32
            ResNet-50 forward and three fused ResNet-50 training steps,
            each eager and through its graphs (training: eager and graph
            with prefetch 0, graph with prefetch 2), the paged server's
            workload through its graphs, and three fine-tune steps,
            once more under torch.profiler: the card's busy and idle share
            of the wall time, and device time by kernel group and by
            category, decoded by the port's `optimize/xplane.py`.

15. rnn:    recurrent and attention networks. TextGenerationLSTM at the
            zoo's width (77 classes, LSTM(256) × 2, 887,117 parameters),
            seeded weights, trained with truncated BPTT 50/50 on a seeded
            synthetic 77-symbol corpus: one B=32, T=120 batch (segments of
            50, 50 and 20: two segment signatures) graph against eager
            bit for bit under cuDNN's deterministic algorithms, with one
            capture per signature; then eager, graph, graph, eager arms of
            one B=32, T=1000 batch (20 segments) each (segments/s,
            characters/s; arms at one batch read one loss; finite).
            Served by `TextGenerationLSTM().generationServer(net,
            slots=8, cache_lengths=[512], method="top_k", top_k=5)`,
            graph then eager: 24 requests (prompts of 5-120 characters
            from the corpus, 64-200 new tokens, greedy and top-k in turn),
            tokens/s and per-token p50/p99; every stream equal across the
            arms, the greedy ones equal to an `rnnTimeStep` loop of the
            net (the smallest top-2 gap along them, and the largest
            |Δlogit| of an 8-slot decode against the one-row carried-state
            forward, printed); no
            capture after warm-up. `ParallelInference` with
            `bucketLadder([1, 2, 4, 8])` and `lengthBuckets([16, 64,
            128])` over the trained net: 12 requests of 5-120 characters
            from as many threads, every answer within 1e-5 of `output()`.
            The attention stack of examples/attention_sequence_classifier.py
            (SelfAttentionLayer(32, 4 heads), LearnedSelfAttentionLayer(32,
            4 heads, 4 queries), LastTimeStep(LSTM(16)), D = 8) trained 30
            full-batch steps graphed and eagerly: test accuracy > 0.8 in
            both, flash_fwd, flash_bwd_dq and flash_bwd_dkv launched in
            the graphed step, `output(fmask=)` of the two within 1e-5,
            one capture. A SelfAttentionLayer at nIn = nOut = 512, 8 heads
            (D = 64), B=16, T=512, ragged masks, forward and backward:
            against the same layer on the kernels' plain versions (1e-4 of
            the largest), the kernels on its own operands at the kernel
            rows' gates, and its ms beside SDPA's. The LSTM paths launch
            none of the nine kernels (counted, checked zero). With
            --profile: one TBPTT batch eager and graphed and the graphed
            server's workload under torch.profiler.
            It runs after the mln phase, before the profile.
16. zoo:    the zoo's graph models at their published widths, f32, TF32
            off, cuDNN's deterministic algorithms, BN statistics and γ/β
            drawn from a seed. InceptionResNetV1 (160×160×3, blocks (5,
            10, 5), 1000 classes, 11,565,192 parameters) with the
            conv1x1+BN fusion on: one B=32 `output()` equal to the
            unfused net's within 1e-4 with 36 matmul_epilogue launches
            (timed both ways); 3 graphed `fit` steps equal to 3 eager ones
            bit for bit, fused and unfused; the first step's loss fused
            vs unfused within 1e-4; then 2 warm-up and 10 timed steps of
            one seeded batch of 32 in the arms fused graph, fused eager,
            unfused graph (ms/step, images/s, peak allocated bytes;
            exactly 36 launches each of matmul_stats, bn_grad_stats and
            bn_conv_grads per fused step, none unfused; the two fused
            arms' losses equal). YOLO2 (416×416×3, 80 classes, 67,445,065
            parameters): `output()` at B=8 is (8, 13, 13, 425);
            `getPredictedObjects` at confidence 0.3 and NMS 0.4 keeps,
            in every example, the boxes a numpy greedy per-class NMS
            keeps on the same decoded tensors; 3 `fit` steps on synthetic
            boxes with finite losses (ms of the output and of the
            detection printed). UNet, TinyYOLO, SqueezeNet, Xception (8
            middle blocks), FaceNetNN4Small2, NASNet and EfficientNet-B0
            at their default inputs, B=8: an output of the right shape
            (softmax rows summing to 1 within 1e-4, UNet's mask in (0,
            1)) and 2 `fit` steps with finite losses; EfficientNet-B0 and
            FaceNetNN4Small2 also fused (their 16 and 21 pairs: the fused
            output within 1e-4 of the unfused one, every pair launching
            the four pair kernels). It runs after the rnn phase.
17. layers: this slice's layer families and the model archives, f32, TF32
            off, cuDNN's deterministic algorithms. CapsNet at Sabour et
            al.'s widths (arXiv:1710.09829 §4: 28×28×1, conv 256 9×9,
            PrimaryCapsules 32×8 9×9/2, CapsuleLayer 10×16 with 3
            routings, CapsuleStrengthLayer, the softmax LossLayer head;
            6,804,224 parameters), one seeded batch of 128, Adam(1e-3):
            3 graphed `fit` steps equal 3 eager ones bit for bit, then 2
            warm-up and 10 timed steps in the arms eager, graph, graph,
            eager (ms/step, images/s, peak allocated bytes; the loss
            finite and falling in each arm). CapsNet saved with its
            updater state and restored onto the card: `output()` equal bit
            for bit, 3 resumed graphed steps equal 3 more steps of the
            uninterrupted net bit for bit. InceptionResNetV1 at its
            published width, fused, after 2 graphed steps, the same, its
            restore keeping its 36 fused pairs (36 matmul_epilogue in one
            `output()`, 36 of each training kernel per resumed step); the
            archives' bytes and save and restore seconds printed. The VAE
            of dl4j-examples' VariationalAutoEncoderExample (784 → 256,
            256 → 2, Bernoulli, LeakyReLU, l2 1e-4, RmsProp(1e-3)), 20
            `pretrainLayer` steps of B=128 binarized synthetic digits: the
            negative ELBO at a fixed ε falls. Each other new family once
            (a 3-D classifier with Deconvolution3D, Deconvolution2D at
            k = 4, s = 2, p = 1 with LRN, LocallyConnected2D with PReLU,
            the 1-D layers, a SameDiffLayer, DropConnect and
            WeightNoise): forward and one `fit` step on the card within
            1e-4 of the CPU run of the same net and parameters (weight
            noise: the forward; its draws are each device's). CapsNet, the
            VAE and the families launch none of the nine kernels (counted,
            checked zero). It runs after the zoo phase.
18. resilience: training that survives faults and fits in memory, on
            `ResNet50()` at its published width (224×224×3, 1000
            classes, f32, TF32 off, Nesterovs(0.01, 0.9), the resnet
            phase's BN draws), cuDNN's deterministic algorithms. The
            fused net through its CUDA graphs, unguarded and under
            `TrainingGuardian(check_every=10)` in turns (2 warm-up and
            10 timed steps an arm, B=32): the two runs equal bit for bit
            (parameters, momentum, BN state, every loss), the guardian
            syncing once per 10 steps, 36 launches of each training
            kernel per guarded step; a NaN in one batch's labels refused
            on the card (equal to the unguarded run that skipped the
            batch, one skipped update); a `StallWatchdog` of 2 s trips
            on a guarded step made to sleep 3 s, its report naming the
            stalled stack, and the next beat clears it.
            `FaultTolerantTrainer` over 30 seeded batches, save_every=10:
            a data fault, a transient dispatch fault and a kill after
            step 22, a new trainer resuming from step 20, ends equal to
            the uninterrupted run (with the same data fault) bit for bit,
            the dropout generator's state included; a corrupt newest
            manifest falls back one generation and the restored net
            keeps its 36 fused pairs; a checkpoint's bytes and its save,
            read, checksum and load seconds printed. NaN batches drive
            the guardian's ladder to its rollback rung: the rollback
            restores the last verified step bit for bit,
            dl4j.guardian.rollbacks reads 1. The unfused net with
            rematPolicy("blocks") against none: the first step's
            gradients equal (bit for bit, else within 1e-6 relative),
            graph and eager arms at B=32 (ms/step, peak allocated bytes),
            remat graph equal to remat eager, then both eager at the
            largest of B=256, 128 that fits without remat; VGG16 under
            rematPolicy("layers") (dropout drawn inside the capture) equal
            to VGG16 without over 3 graphed steps. `nd` draws and 14
            Transforms on the card against the CPU, the native runtime
            (built with g++) against numpy, the op executioner's counts.
            It runs after the layers phase.
19. quant:  fine-tune, then serve int8, on `ResNet50()` at its published
            width (224×224×3, 1000 classes, the resnet phase's BN draws),
            f32 with cuDNN's TF32 off. The net is saved and restored with
            `ModelSerializer` (the "pretrained" source; restored equal bit
            for bit). `TransferLearning.GraphBuilder` freezes everything up
            to res4_5_relu, removes "fc" and adds a head (DenseLayer 2048 →
            256, relu, `PrecisionPolicy.int8()`: QAT in the graphed step;
            a 10-class OutputLayer), built with the fusion on: 7 fused
            pairs (res5's). `EarlyStoppingGraphTrainer` (MaxEpochs 5,
            ScoreImprovement 2, `DataSetLossCalculator` on 2 held-out
            batches, a `LocalFileModelSaver`) over 8 seeded batches of 32
            of a learnable 10-class task (class patterns plus noise), with
            a `ScoreIterationListener` and a `StatsListener` into an
            `InMemoryStatsStorage` that a `UIServer` serves. Gates: B5, B7
            and B8 each launch 7 times a step; `GET /stats` gives one
            record per iteration, update ratios exactly 0 for the frozen
            parameters and > 0 for res5 and the head; the frozen
            parameters and BN state bit for bit unchanged, the source
            equal to its values before; the restored best model equal to
            an in-memory clone of it bit for bit. `quantize_network(best,
            data=[2 training batches])`: 37 int8 layers, 17 fallbacks, 36
            folded BNs; one int8 forward launches B6's int8 route 37
            times; each quantized layer equals B6's plain version from the
            same input within 1e-6 of its largest value (an FMA's ulp),
            the whole forward of 4 rows equals the CPU twin through the
            plain version within 5e-2 (softmax) with its top-1; int8 top-1
            agrees with the fp best model on ≥ 0.95 of 256 held-out
            images. 96 images from 8 threads through
            `ParallelInference(BATCHED, batchLimit=32)` with the bucket
            ladder: answers within 5e-2 of `output()` with its top-1, 37
            int8 launches a forward; the head's activation scale
            recalibrated in place (×1.25): answers change, no capture.
            Printed: fp and int8 B=32 forwards through their graphs in
            turns, the fine-tune step's ms; with --profile, both forwards'
            device time by group (B6 int8, the quantize passes, cuDNN) and
            idle share. It runs after the resilience phase.
20. parallel: data- and sequence-parallel training over
            `torch.distributed`, in rank processes the phase spawns and
            joins against a deadline (every process group with a
            timeout; a rank that fails or hangs fails the run). The ranks
            load the kernels this run built (they count no nvcc) and send
            their launch counts back. Arm A, NCCL, one rank per card: the
            long-context recipe of examples/long_context_bert.py at
            BERT-base width, cut to PAR["layers"] = 4 layers (T = 4096,
            B = 2, remat, Adam under ZeRO-1)
            through `ShardedTrainer` with the flash ring as attn_impl, 3
            steps, against the same trainer with attn_impl="flash"
            (gradients per leaf and losses, PAR_GRAD_RTOL and
            PAR_LOSS_RTOL); `ParallelWrapper` on fused ResNet-50 at B = 32,
            graphed: 2 steps bit for bit equal to `net.fit`'s and to its
            own eager steps, the NCCL all-reduce captured in the graph.
            Arm B, two gloo ranks on the first card (host-staged hops):
            the same recipe at dp = 1, sp = 2 against arm A's gradients and
            losses; the causal and the masked flash ring against the plain
            ring and Ulysses with flash_attention against single-device
            flash (forward and gradients); `ParallelWrapper` on fused
            ResNet-50 at 2 × 16 rows (synchronized BN) against arm A's one
            rank on 32, 2 steps; the recipe's 4 layers as a 2-stage GPipe
            pipeline of 4 microbatches against the sequential forward.
            Printed: ms/step and peak allocated bytes per arm, each rank's
            launches per step of B1/B2a/B2b and B5/B7/B8.
21. multihost: multi-host training that survives preemption, peer loss
            and churn (parallel/multihost.py), in rank processes spawned and
            joined against a deadline; each rank runs the hardened bootstrap
            (`multihost.initialize`: a loopback TCPStore hosted by process
            0, every group with a timeout). Arm A, NCCL, one rank: BERT-base
            width at `a_layers` = 4 layers fine-tuning (the train phase's
            batch, dropout 0.1, Adam 2e-5,
            attn_impl="flash") through MultiHostTrainer(accumulation=2,
            buckets=4, compress=True) under MultiHostRunner with a
            PeerCoordinator and a CoordinatedGuardian, save_every=2, 4
            optimizer steps: 8 launches of each of B1/B2a/B2b per optimizer
            step (2 per layer); per bucket the shipped payload plus the new
            residual equals the gradient plus the old residual
            (MH_MASS_RTOL);
            compress=False with 4 buckets equals ShardedTrainer bit for bit;
            the exchange order the step recorded and a torch.profiler
            trace's order pass `check_overlap_structure`; a preemption
            injected at host.preempt drains into a verified checkpoint and a
            fresh rank process resumes to step 4 equal to the uninterrupted
            run bit for bit (parameters, Adam and encoder state). Arm B, two
            gloo ranks on the first card (host-staged), BERT-base width at
            `b_layers` layers: the sparse wire equals the dense one bit for
            bit; preempt@2 plus a resume in fresh processes equals the clean
            run bit for bit; a graceful leave 2 → 1 and a join_cluster
            1 → 2 re-form the group (residual mass conserved, lockstep after
            the join); rank 1 exits inside sync round 2 and rank 0 raises
            PeerLostError, with a report, within the peer timeout plus
            MH_LOST_SLACK_S. Arm A's processes and arm B's pairs run side by
            side, and the phase beside the parallel phase (their work is
            all in the ranks they spawn; the times they print include each
            other's load). Printed: ms per optimizer step (compressed, raw
            buckets), the coordinated save's seconds and bytes,
            encoder_stats, the overlap orders.
22. keras:  Keras MobileNetV2 (keras.applications.MobileNetV2 at alpha
            1.0, 224×224×3, 1000 classes: its Functional JSON built here
            with Keras's layer names and settings, nothing downloaded)
            imported by `KerasModelImport.importKerasModelAndWeights(json,
            None)` with the conv1x1+BN fusion on: 3,538,984 parameters
            (Keras's count) and 34 pairs; the BN statistics and γ/β drawn
            from a seed. One B=32 forward through a bucket graph of
            `ParallelInference` launches matmul_epilogue 34 times and
            equals the unfused import's eager forward within KERAS_RTOL.
            `profile_next_steps(3)` armed before the fresh import's first
            `fit` at B=32: that step captures the step's graph with the
            window shut (the session is still armed after it), the next
            3 replay it (34 launches of each of B5, B7, B8 a step) inside
            the window, and the fit store captured once, degraded
            nothing and ran nothing eagerly; then 2 warm-up and 10 timed
            graphed steps (ms/step). The session ends done over 3 steps,
            its report (decoded by `optimize/xplane.py`) lists
            matmul_stats_kernel, bn_grad_stats_kernel and
            bn_conv_grads_kernel as custom-call rows whose counts equal
            the launch counters (bn_conv_grads_sum_kernel's equals
            bn_conv_grads'), and its device self time fits in its wall
            time. `ProfilerListener` over one more step gives a report.
            BERT-base's fine-tune step (phase 6's) under a session over
            3 steps: flash_fwd, flash_bwd_dq and flash_bwd_dkv rows of 36
            each. Printed: ms per step, the top 5 ops and the category
            rollup of both; the reports land in chiprun_out/.
23. samediff: a frozen TensorFlow BERT-base GraphDef written here with
            the port's tfproto encoder from the seeded `bert_base()`
            parameters (GatherV2 embeddings, layer norm as Mean /
            SquaredDifference / Rsqrt, MatMul / BatchMatMulV2 / Softmax
            under the additive mask, google-research BERT's tanh GELU,
            the pooler and a classifier), B=8, T=128, ragged masks,
            through `importFrozenTF` on the card: the last hidden states
            of the valid tokens equal the port's flash encoder within
            SAMEDIFF_RTOL; 3 `fit` steps (every weight a variable, Adam)
            with finite losses; `save`, then `load_samediff` and
            `ModelGuesser.loadModelGuess`, each giving outputs
            bit-identical to the saved graph's. None of the nine kernels
            launches on the SameDiff path (counted, checked zero).
            Printed: the node count, ms per `output()` and per fit step,
            the archive's bytes and seconds.
24. onnx:   the fused `ResNet50()` (224×224×3, 1000 classes, the resnet
            phase's BN draws) written here as an opset-13 ONNX ModelProto
            (`graph_onnx`: NCHW, OIHW weights and the BN running
            statistics as raw_data initializers; Conv, BatchNormalization,
            Relu, MaxPool, Add, GlobalAveragePool, Flatten, Gemm,
            Softmax), imported by `importOnnx` on the card: `output()` at
            B=32 within RESNET_RTOL of the fused net's forward, top-1 equal
            on all 32, that forward launching matmul_epilogue 36 times and
            the SameDiff path none; `convertConstantsToVariables` (weights,
            γ, β), 3 `fit` steps on one batch (Adam) whose loss falls;
            `save`, then `load_samediff` and `ModelGuesser`, outputs
            bit-identical. Printed: nodes, import s, output() ms, fit
            ms/step, the archive's bytes and seconds.
25. spark:  SPARK's 10 × 32 seeded 256×256 RGB images written as PNGs in
            class folders, read by `ImageRecordReader(224, 224, 3,
            ParentPathLabelGenerator(), PipelineImageTransform(flip, random
            192² crop), nativeLoader=True)` and `ImageRecordDataSetIterator`
            (32, scaled to [0, 1]); the 10 batches parallelized over 4
            slices into `SparkComputationGraph(SharedTrainingMaster)` over
            fused ResNet-50 (10 classes, Nesterovs 0.01) at one NCCL rank,
            cuDNN deterministic: 2 epochs, the second under torch.profiler
            (ms/step, images/s, idle share) with 36 launches of each of B5,
            B7, B8 a step; the parameters and BN state bit-equal to
            `ParallelWrapper.Builder(net).workers(1)` over the same
            `ListDataSetIterator` and to `ParameterAveragingTrainingMaster
            (averagingFrequency 5)`; `evaluate(rdd)` equal to an
            `Evaluation` over `net.output`. Printed: the host's record ms a
            batch (decode, C++ resize, flip, crop, PIL resize).
26. arbiter: `LocalOptimizationRunner(TPEGenerator({lr: log 1e-4..1e-1,
            momentum: 0.9 | 0.95}, seed 5, 2 startup trials))` over 4 fresh
            fused ResNet-50 candidates (Nesterovs), each 5 graphed steps on
            the spark phase's batches (36 launches of each of B5, B7, B8 a
            replayed step), scored by the loss on a held-out batch; and a
            `MultiLayerSpace` at the zoo LeNet's widths (learning rate and
            dense width as spaces) under `RandomSearchGenerator`, 4
            candidates of 1 epoch, fed by `CSVRecordReader` ->
            `TransformProcess` -> `RecordReaderDataSetIterator` over a
            10,000-row seeded MNIST-shaped CSV written here. Gates: every
            score finite, `bestResult()` the minimum, a second generator fed
            the same scores yields the same candidates. Printed: each
            candidate's seconds, capture included.
27. clustering: CLUSTER's 100,000 points of a 100-blob mixture at D =
            2048 (ResNet-50's pooled width; 819 MB f32) made on the card:
            `KMeansClustering.setup(100, 20, "euclidean", k-means++)`
            purity ≥ CLUSTER_PURITY and, from the same start, centers within
            CLUSTER_RTOL of an f64 Lloyd with equal assignments; `knn` of
            10,000 queries, k = 10, each of 256 picks within KNN_TIE_RTOL of
            an f64 brute force's k-th best; `VPTree` on 10,000 points equal
            to `knn`, `KDTree` at D = 3 equal to a brute force;
            `BarnesHutTsne` on 5,000 points, 500 iterations, whose KL falls;
            `UIServer.attachTsne` of 3-D vectors; `NearestNeighborsServer`
            over loopback answering 16 queries as `knn`. Printed: ms per
            Lloyd iteration, knn ms, t-SNE s, peak allocated bytes.
28. nlp:    word, document, subword and graph embeddings at their
            published widths (NLP) on seeded data: a Zipf corpus of
            ~1.46 M tokens and 71,000 types in 50 topics; Word2Vec SGNS
            (D = 300, window 5, negative 5, sample 1e-3, lr 0.025, batch
            1024) one epoch on a corpus of the same 71,000 types at
            ~0.71 M tokens, whose first batch's loss falls and whose
            1,000 most frequent words are closer within a topic than
            across; Word2Vec HS and FastText (2,000,000 buckets, n-grams
            3–6) on the first 400 k tokens (an OOV word nearest its
            stem); GloVe (window 10, xMax 100, alpha 0.75) on the first
            300 k tokens, its loss falling; PV-DBOW and PV-DM (D = 400,
            window 10) on 1,000 documents of 230 tokens, `nearestLabels`
            putting the own label of 20 training documents in the top 5;
            DeepWalk (d = 128, window 10, walks of 40, one a vertex) on a
            graph of BlogCatalog's 10,312 vertices and 333,983 edges in 39
            communities, closer within a community than across; Kim's
            sentence CNN over the SGNS vectors (windows 3/4/5 × 100 maps,
            dropout 0.5, minibatch 50) on 10,662 labelled sentences, 2
            epochs, its loss falling and `output()` equal to the CPU's to
            NLP_CNN_RTOL. Each arm's first step runs again on the card
            (bit-identical) and through the port on the CPU (within
            NLP_STEP_RTOL; the infer step NLP_INFER_RTOL); the SGNS vectors
            round-trip through the binary (bit for bit) and text (to the
            format's 6 decimals) word2vec files; the three example twins
            run. Printed: each arm's host seconds apart from its step
            loop's, steps/s, pairs/s, peak allocated bytes. The nine
            kernels' counters read 0 across the phase.
29. rl:     rl4j's learners at the Atari widths (RL), f32, TF32 off,
            cuDNN deterministic. A: `QLearningDiscreteConv` at the JAX
            package's defaults (Mnih et al. 2013: 16 filters 8×8/4, 32
            4×4/2, 256 dense; 84×84, history 4, skip 4; batch 32) on
            `PixelGridWorld(21, 8)`'s 168×168 frames, 1,500 agent steps,
            replay 10,000: one `td_learn_batch` from the trained weights,
            Adam moments and replay on two card learners (bit-identical)
            and a CPU one (the probe's Q-values and the parameters within
            RL_CONV_RTOL, the update within RL_DELTA_RTOL); a fixed probe
            batch's mean |TD error| against the first target net falls
            from the first update to just before the first target sync
            (its value after the last update printed: the targets move
            at every sync); target syncs = maxStep //
            targetDqnUpdateFreq.
            B: `A3CDiscreteConv` at the same network and
            `A3CConfiguration()` (8 envs, nstep 5), 100 updates of 40
            rows. C: `A3CDiscreteDense` and
            `AsyncNStepQLearningDiscreteDense` (2×64, 8 envs) on
            `CartpoleNative`, 2,000 env steps each. B and C: one update
            from the trained params and RMSprop state on the last rollout,
            twice on the card (bit-identical) and on a CPU twin (B
            RL_CONV_RTOL, C RL_DENSE_RTOL), the loss finite, the n-step
            learner's v head unchanged. Printed: steps/s, updates/s, the
            host's share of arm A's loop outside its network calls, host
            reads, arm A's peak allocated bytes above what it found. The
            nine kernels' counters read
            0 across the phase.
30. examples: the 15 twins of examples/ this slice adds
            (`deeplearning4j_tpu_torch/examples/`), each `main()` on the
            card at its script's settings but dqn_cartpole's steps
            (EXAMPLE_KW: 4,000 of the script's 12,000), timed; the
            scripts' checks raise inside them (pixel DQN play > 0.9,
            attention accuracy > 0.8, YOLO class 1, MDN samples near ±2,
            the custom layer's round trip); every number a twin returns
            and every loss it prints finite; B1, B2a and B2b
            launched by attention_sequence_classifier and
            long_context_bert, none of the nine by the other 13 (counted
            per twin: the kernel line's `launches_examples`).

Phases 5, 7 and 8 run as a user runs them: the server and `fit` replay
CUDA graphs on the card by default. The kernels' launch counters are set
to 0 just before each main path (the encoder, serving, the timed training
steps, ResNet serving, the timed ResNet training steps, each arm of the
graphs phase, each server of the chaos phase, each run of the fleet
phase and each path of the rnn phase) and read just after; a replay adds
the launches its capture recorded. The mln phase and the rnn phase's LSTM
paths run none of them: their counts are read and must stay 0. The zoo,
layers, resilience and quant phases' counts are set to 0 before each of
their paths, and the parallel and multihost phases' ranks set theirs to
0 before each of theirs; the keras phase's before its forward, its
profiled steps, its timed steps and BERT's profiled steps, the samediff
phase's before its import, the onnx phase's before the import and again
before the fused forward, the spark phase's before its second epoch and
the arbiter phase's before each candidate's replayed steps and the LeNet
search; the nlp and rl phases' at their start, read at their end (0
each), the examples phase's before each twin. Every
number is measured in this run; the last lines are the kernel JSON object
and the `{"ok": true, "device": ...}` line. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import functools
import gc
import importlib
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.datasets import (ArrayDataSetIterator,
                                               DataSet, ListDataSetIterator,
                                               MnistDataSetIterator)
from deeplearning4j_tpu_torch.generation import (BertDecoder,
                                                 GenerationServer,
                                                 RecurrentDecoder)
from deeplearning4j_tpu_torch.kernels import _build
from deeplearning4j_tpu_torch.kernels.flash_attention import (
    _decode_reference, _delta, _dkv_reference, _dq_reference,
    _flash_forward, _flash_forward_reference, decode_cluster_size,
    flash_attention_decode, flash_attention_decode_mq,
    flash_attention_decode_paged, flash_bwd_dkv, flash_bwd_dq, flash_decode,
    flash_fwd, decode_head_dim_plan, gather_kv_pages)
from deeplearning4j_tpu_torch.models import (bert_base, bert_classify,
                                             bert_encode, bert_mlm_logits,
                                             bert_tiny, classification_loss,
                                             init_bert_params, param_leaves)
from deeplearning4j_tpu_torch.kernels.layernorm import (
    _layernorm_reference, fused_layernorm)
from deeplearning4j_tpu_torch.kernels.pointwise_conv import (
    _bn_conv_grads_reference, _bn_dy, _bn_grad_stats_reference,
    _epilogue_reference, _fwd_tile, _matmul_stats_reference, bn_conv_grads,
    bn_grad_stats, int8_matmul_epilogue, matmul_epilogue, matmul_stats)
from deeplearning4j_tpu_torch.kernels.residual_block import (
    _plan as _block_plan_of, bottleneck_block, bottleneck_block_xla)
from deeplearning4j_tpu_torch.models.convert import named_param_leaves
from deeplearning4j_tpu_torch.models.zoo import (
    VGG16, YOLO2, EfficientNet, FaceNetNN4Small2, InceptionResNetV1, NASNet,
    ResNet50, SqueezeNet, TextGenerationLSTM, TinyYOLO, UNet, Xception)
from deeplearning4j_tpu_torch.nn import (
    LSTM, Activation, Adam, BackpropType, ComputationGraph,
    Convolution1DLayer, ConvolutionLayer, DenseLayer, GlobalPoolingLayer,
    InputType, LastTimeStep, LearnedSelfAttentionLayer, LocallyConnected1D,
    LocallyConnected2D, LossLayer, MaxNormConstraint, MultiLayerNetwork,
    Nesterovs, NeuralNetConfiguration, OutputLayer, PReLULayer, RmsProp,
    SelfAttentionLayer, StepSchedule, Subsampling1DLayer, SubsamplingLayer,
    Upsampling1D, VariationalAutoencoder, WeightInit,
    graph_params_from_numpy, graph_params_to_numpy,
    multilayer_params_to_numpy)
from deeplearning4j_tpu_torch.nn.conf import attention as attn_conf
from deeplearning4j_tpu_torch.nn.conf.capsules import (CapsuleLayer,
                                                       CapsuleStrengthLayer,
                                                       PrimaryCapsules)
from deeplearning4j_tpu_torch.nn.conf.graph_vertices import MergeVertex
from deeplearning4j_tpu_torch.nn.conf.layers import (
    Cropping1D, Deconvolution2D, DropoutLayer,
    ElementWiseMultiplicationLayer, LocalResponseNormalization,
    ZeroPadding1DLayer)
from deeplearning4j_tpu_torch.nn.conf.layers3d import (Convolution3D,
                                                       Cropping3D,
                                                       Deconvolution3D,
                                                       Subsampling3DLayer,
                                                       Upsampling3D,
                                                       ZeroPadding3DLayer)
from deeplearning4j_tpu_torch.nn.conf.samediff_layers import SameDiffLayer
from deeplearning4j_tpu_torch.nn.conf.variational import \
    BernoulliReconstructionDistribution
from deeplearning4j_tpu_torch.nn.conf.weightnoise import (DropConnect,
                                                          WeightNoise)
from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper
from deeplearning4j_tpu_torch.parallel.inference import (InferenceMode,
                                                         ParallelInference)
from deeplearning4j_tpu_torch.optimize import (
    DataSetLossCalculator, EarlyStoppingConfiguration,
    EarlyStoppingGraphTrainer, InMemoryModelSaver, LocalFileModelSaver,
    MaxEpochsTerminationCondition, ScoreImprovementEpochTerminationCondition,
    ScoreIterationListener)
from deeplearning4j_tpu_torch.quantize import (PrecisionPolicy,
                                               QuantizedConv1x1,
                                               QuantizedDense,
                                               cache_page_bytes,
                                               quantize_network,
                                               quantize_rows)
from deeplearning4j_tpu_torch.quantize.infer import (
    QuantizedComputationGraph, recalibrate)
from deeplearning4j_tpu_torch.transfer import (FineTuneConfiguration,
                                               TransferLearning)
from deeplearning4j_tpu_torch.ui import (InMemoryStatsStorage, StatsListener,
                                         UIServer)
from deeplearning4j_tpu_torch.util.model_guesser import ModelGuesser
from deeplearning4j_tpu_torch.util.model_serializer import ModelSerializer
from deeplearning4j_tpu_torch.autodiff import (TrainingConfig, VariableType,
                                               importFrozenTF, importOnnx)
from deeplearning4j_tpu_torch.clustering import (BarnesHutTsne, KDTree,
                                                 KMeansClustering,
                                                 NearestNeighborsServer,
                                                 VPTree, knn)
from deeplearning4j_tpu_torch.autodiff.graph_serde import load_samediff
from deeplearning4j_tpu_torch.graph import DeepWalk, Graph
from deeplearning4j_tpu_torch.graph import deepwalk as graph_dw
from deeplearning4j_tpu_torch.nlp import (CnnSentenceDataSetIterator,
                                          CollectionLabeledSentenceProvider,
                                          FastText, Glove, ParagraphVectors,
                                          Word2Vec, WordVectorSerializer)
from deeplearning4j_tpu_torch.nlp import fasttext as nlp_ft
from deeplearning4j_tpu_torch.nlp import glove as nlp_glove
from deeplearning4j_tpu_torch.nlp import paragraph_vectors as nlp_pv
from deeplearning4j_tpu_torch.nlp import word2vec as nlp_w2v
from deeplearning4j_tpu_torch.keras_import import KerasModelImport
from deeplearning4j_tpu_torch import rl
from deeplearning4j_tpu_torch.optimize import ProfilerListener, xplane
from deeplearning4j_tpu_torch import monitoring as mon
from deeplearning4j_tpu_torch.monitoring import events as ev
from deeplearning4j_tpu_torch.monitoring import memory as _mem
from deeplearning4j_tpu_torch.resilience import faults
from deeplearning4j_tpu_torch.resilience.errors import (
    MemoryPressureError, PagePoolExhaustedError, ServerDeadError)
from deeplearning4j_tpu_torch.resilience.policy import RetryPolicy
from deeplearning4j_tpu_torch.runtime.executables import (ENV_CACHE_DIR,
                                                          ExecutableStore,
                                                          forward_fn,
                                                          tensor_leaves)

OUT_DIR = Path(__file__).resolve().parent / "chiprun_out"
#: the card; a rehearsal of a phase on the CPU sets "cpu" (the kernel
#: wrappers then run their plain versions)
DEV = "cuda"

#: published H100 SXM peaks (NVIDIA data sheet; dense, 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12,      # f32 outside the tensor cores
              torch.bfloat16: 989e12,    # bf16 tensor cores
              torch.int8: 1979e12}       # int8 tensor cores (TOP/s)
#: TF32 tensor cores: bn_conv_grads, the forward GEMMs and the flash
#: kernels but decode take f32 through them as 3×TF32, three TF32 products
#: for each f32 product
PEAK_TF32 = 495e12
#: the flash kernels whose f32 route is 3×TF32 on the tensor cores
#: (flash_decode runs f32 FMA)
TF32_FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
#: kernel vs plain version: f32 sums run in another order; bf16 rounds
#: its output to 8 mantissa bits. Gradients, the epilogue GEMM and the
#: bottleneck block are held to the same atol scaled by
#: max(1, max |plain|): their size grows with the sums they take. int8:
#: the int32 sums must be bit-exact, the f32 epilogue within INT8_RTOL
ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
INT8_RTOL = 1e-5
DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16",
               torch.int8: "int8"}

#: the encoder phase's padding: ragged, every example non-empty
ENCODE_LENS = [128, 100, 64, 17, 128, 1, 90, 128]
#: the kernel-check case whose numbers stand for each kernel in the JSON
#: line: the shapes the serving path gives it
REPRESENTATIVE = {"flash_fwd": ("prefill P=128", "f32"),
                  "flash_decode": ("decode C=512", "f32"),
                  "flash_bwd_dq": ("train B=32 T=128", "f32"),
                  "flash_bwd_dkv": ("train B=32 T=128", "f32"),
                  "matmul_epilogue": ("res2_c B=32", "f32"),
                  "int8_matmul_epilogue": ("res4_a B=32", "int8"),
                  "bottleneck_block": ("res4 B=32", "f32"),
                  "matmul_stats": ("res2_c B=32", "f32"),
                  "bn_grad_stats": ("res2_c B=32", "f32"),
                  "bn_conv_grads": ("res2_c B=32", "f32"),
                  "fused_layernorm": ("bert_base 4096x768", "f32")}

SOURCES = {
    "flash_fwd": ("deeplearning4j_tpu_torch/kernels/csrc/flash_fwd.cuh",
                  "deeplearning4j_tpu/kernels/flash_attention.py:42"),
    "flash_decode": ("deeplearning4j_tpu_torch/kernels/csrc/flash_decode.cu",
                     "deeplearning4j_tpu/kernels/flash_attention.py:42"),
    "flash_bwd_dq": ("deeplearning4j_tpu_torch/kernels/csrc/flash_bwd_dq.cuh",
                     "deeplearning4j_tpu/kernels/flash_attention.py:232"),
    "flash_bwd_dkv": (
        "deeplearning4j_tpu_torch/kernels/csrc/flash_bwd_dkv.cuh",
        "deeplearning4j_tpu/kernels/flash_attention.py:272"),
    "matmul_epilogue": (
        "deeplearning4j_tpu_torch/kernels/csrc/matmul_epilogue.cu",
        "deeplearning4j_tpu/kernels/pointwise_conv.py:116"),
    "int8_matmul_epilogue": (
        "deeplearning4j_tpu_torch/kernels/csrc/matmul_epilogue.cu",
        "deeplearning4j_tpu/kernels/pointwise_conv.py:116"),
    "bottleneck_block": (
        "deeplearning4j_tpu_torch/kernels/csrc/bottleneck_block.cu",
        "deeplearning4j_tpu/kernels/residual_block.py:38"),
    "matmul_stats": ("deeplearning4j_tpu_torch/kernels/csrc/matmul_stats.cu",
                     "deeplearning4j_tpu/kernels/pointwise_conv.py:47"),
    "bn_grad_stats": (
        "deeplearning4j_tpu_torch/kernels/csrc/bn_grad_stats.cu",
        "deeplearning4j_tpu/kernels/pointwise_conv.py:206"),
    "bn_conv_grads": (
        "deeplearning4j_tpu_torch/kernels/csrc/bn_conv_grads.cu",
        "deeplearning4j_tpu/kernels/pointwise_conv.py:262"),
    "fused_layernorm": ("deeplearning4j_tpu_torch/kernels/csrc/layernorm.cu",
                        "deeplearning4j_tpu/kernels/layernorm.py:21"),
}
#: flops per valid (query, key) pair: the forward's two products, the dQ
#: kernel's three (S, dO·Vᵀ, dS·K), the dK/dV kernel's four
FLOPS_PER_PAIR = {"flash_fwd": 4, "flash_bwd_dq": 6, "flash_bwd_dkv": 8}


#: (path, start) of the run's timeline, set by main(): every log line's
#: first line, after the seconds since the start, so a slow phase shows
#: where inside it the time went
_TIMELINE = None


def _mark(msg):
    """Add `msg`'s first line to the timeline (when main() set one)."""
    if _TIMELINE is not None:
        path, start = _TIMELINE
        with open(path, "a") as f:
            f.write(f"{time.perf_counter() - start:8.1f} "
                    f"{str(msg).splitlines()[0][:200] if msg else ''}\n")


def log(msg):
    print(msg, flush=True)
    _mark(msg)


def _child_timeline(tag, start, names):
    """In a rank process: a timeline of its own, on the parent's clock
    (`start`, the parent's time.perf_counter() origin; the clock is the
    system's monotonic one), with each of the functions `names` marked
    where it starts and ends."""
    global _TIMELINE
    if start is None:
        return
    _TIMELINE = (OUT_DIR / f"smoke_timeline_{tag}.log", start)
    g = globals()
    for n in names:
        def marked(*a, _fn=g[n], _n=n, **kw):
            _mark(f"[{tag}] {_n} starts")
            t = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                _mark(f"[{tag}] {_n} took {time.perf_counter() - t:.1f} s")
        g[n] = marked
    _mark(f"[{tag}] process up")


def time_ms(fn, iters=20):
    """Mean device time of one call, by CUDA events over `iters` calls
    after three warm-up calls. The stream first sleeps ~20 ms on the
    card, so the host queues every call before the first starts: the
    events read device time alone, without host-side launch gaps."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops, nbytes, dtype, peak=None):
    """The least time (ms) the card could take: the larger of the bytes
    over the memory rate and the operations over the dtype's peak (or
    `peak`, for a kernel whose route runs at another rate)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / (peak or PEAK_FLOPS[dtype]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 1 ------------------------------------------------------------------
def phase_card():
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    line = line.strip().splitlines()[0]
    log(line)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    return line


# -- phase 2 ------------------------------------------------------------------
def phase_build():
    res = _build.build_all(verbose=True)
    log(f"[build] {len(res['logs'])} kernels in {res['seconds']:.2f} s")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "build_log.txt").write_text(
        "\n".join(f"== {n}\n{t}" for n, t in res["logs"].items()))
    for name, text in res["logs"].items():
        for fn, regs, spills in _ptxas_report(text):
            log(f"[build] {name}: {fn}: {regs}; {spills}")
    return res["seconds"]


def _ptxas_report(text):
    """(kernel, registers line, spill line) per instantiation in nvcc's
    `-Xptxas -v` output, the kernel's name demangled where c++filt exists
    and cut to the name and its template arguments."""
    out, fn, spills = [], "?", ""
    for ln in text.splitlines():
        ln = ln.strip()
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1]
        elif "spill" in ln:
            spills = ln
        elif "registers" in ln:
            out.append([fn, ln.split(":", 1)[-1].strip(), spills])
    if out and shutil.which("c++filt"):
        names = subprocess.run(
            ["c++filt"], input="\n".join(r[0] for r in out),
            capture_output=True, text=True, timeout=60).stdout.splitlines()
        for r, full in zip(out, names):
            m = re.search(r"(\w+(?:<[^()]*>)?)\(", full)
            r[0] = m.group(1) if m else full
    return out


# -- phase 3 ------------------------------------------------------------------
def _ragged_mask(lengths, t, dev):
    lens = torch.tensor(lengths, device=dev)
    return torch.arange(t, device=dev)[None, :] < lens[:, None]


def _randn(gen, dtype, *shape):
    return torch.randn(shape, generator=gen, device=DEV).to(dtype)


def _work(name, b, h, tq, tk, d, causal, mask, esz):
    """(flops, bytes) that this run's data needs: only valid (query, key)
    pairs — the zeroed query rows of a padded self-attention example need
    none — and each input read once, each output written once in full.
    K and V rows that the key mask removes are not read; in self-attention
    neither are the q, dO, lse and Δ rows of padded queries (their P is
    exactly 0)."""
    vk = (torch.full((b,), tk) if mask is None else mask.sum(1)).float()
    self_masked = tq == tk and mask is not None and not causal
    if causal:
        pairs = b * h * tq * (tq + 1) / 2
    elif self_masked:
        pairs = h * float((vk ** 2).sum())
    else:
        pairs = h * tq * float(vk.sum())
    flops = FLOPS_PER_PAIR[name] * pairs * d
    vq = h * float(vk.sum()) if self_masked else b * h * tq  # valid q rows
    q_in = vq * d * esz                      # the valid rows of q or dO
    q_out = b * h * tq * d * esz             # one whole (B, H, Tq, D)
    kv_rows = h * float(vk.sum()) * d * esz  # the valid rows of K or V
    masks = 0 if mask is None else mask.numel()
    if name == "flash_fwd":                  # q, k, v -> o, lse
        nbytes = q_in + q_out + 2 * kv_rows + b * h * tq * 4 + masks
    elif name == "flash_bwd_dq":             # q, k, v, dO, lse, Δ -> dq
        nbytes = 2 * q_in + q_out + 2 * kv_rows + 2 * vq * 4 + masks
    else:                                    # the same -> dk, dv
        nbytes = (2 * q_in + 2 * kv_rows + 2 * vq * 4 + masks
                  + 2 * b * h * tk * d * esz)
    return flops, nbytes


def _flash_bound(name, b, h, tq, tk, d, causal, mask, dtype):
    """The least time of a flash kernel on its route: f32 through 3×TF32
    (three TF32 operations per f32 operation at the TF32 rate) where the
    kernel takes that route, else the dtype's own rate."""
    flops, nbytes = _work(name, b, h, tq, tk, d, causal, mask,
                          torch.finfo(dtype).bits // 8)
    if dtype == torch.float32 and name in TF32_FLASH:
        return bound(3 * flops, nbytes, dtype, PEAK_TF32)
    return bound(flops, nbytes, dtype)


def _fwd_case(label, b, h, tq, tk, d, causal, lengths, dtype, gen):
    dev = torch.device(DEV)
    q = _randn(gen, dtype, b, h, tq, d)
    k = _randn(gen, dtype, b, h, tk, d)
    v = _randn(gen, dtype, b, h, tk, d)
    mask = None if lengths is None else _ragged_mask(lengths, tk, dev)
    out, lse = flash_fwd(q, k, v, mask, causal)
    again = flash_fwd(q, k, v, mask, causal)
    ref, ref_lse = _flash_forward_reference(q, k, v, mask, causal)
    exact, exact_lse = _flash_forward_reference(q.double(), k.double(),
                                                v.double(), mask, causal)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    # against f64, the lse where it is no sentinel (±1e30 differ by far
    # more than any error between f32 and f64)
    live = exact_lse.abs() < 1e29

    def from_f64(o, l):
        return max((o.double() - exact).abs().max().item(),
                   (l.double() - exact_lse).abs().where(live, 0).max().item())
    f64_err, plain_f64_err = from_f64(out, lse), from_f64(ref, ref_lse)
    del exact, exact_lse
    identical = torch.equal(out, again[0]) and torch.equal(lse, again[1])
    bms, by = _flash_bound("flash_fwd", b, h, tq, tk, d, causal, mask, dtype)
    ms = time_ms(lambda: flash_fwd(q, k, v, mask, causal))
    plain = time_ms(lambda: _flash_forward_reference(q, k, v, mask,
                                                        causal))
    am = None if mask is None else mask[:, None, None, :]
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=am, is_causal=causal))
    return dict(name="flash_fwd", case=label, shape=[b, h, tq, tk, d],
                dtype=DTYPE_NAMES[dtype], causal=causal,
                max_abs_err=max(err, lse_err), out_err=err,
                lse_err=lse_err, atol=ATOL[dtype], f64_err=f64_err,
                plain_f64_err=plain_f64_err, bit_identical=identical,
                ms=ms, plain_ms=plain,
                library_ms=lib, bound_ms=bms, bound_by=by)


def _decode_case(label, b, h, c, d, lengths, dtype, gen):
    dev = torch.device(DEV)
    q = torch.randn((b, h, 1, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, h, c, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, h, c, d), generator=gen, device=dev).to(dtype)
    mask = _ragged_mask(lengths, c, dev)
    on_card = dev.type == "cuda"   # a CPU rehearsal runs the plain version
    # past D = 1024 decode runs flash_fwd with one query row
    wide = decode_head_dim_plan(d) is None
    kernel = flash_fwd if wide else flash_decode
    before = kernel.launches
    out = flash_decode(q, k, v, mask)
    if on_card and kernel.launches - before != 1:
        raise AssertionError(f"flash_decode {label}: "
                             f"{kernel.launches - before} launches of "
                             f"{kernel.__name__} for one call")
    again = flash_decode(q, k, v, mask)
    ref = _decode_reference(q, k, v, mask)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    empty = [i for i, n in enumerate(lengths) if n == 0]
    if empty and out[empty].abs().max().item() != 0:
        raise AssertionError(f"flash_decode {label}: empty rows not zero")
    valid = float(mask.sum())
    esz = q.element_size()
    flops = 4.0 * h * valid * d
    nbytes = 2 * b * h * d * esz + 2 * h * valid * d * esz + mask.numel()
    bms, by = bound(flops, nbytes, dtype)
    ms = time_ms(lambda: flash_decode(q, k, v, mask), iters=50)
    plain = time_ms(lambda: _decode_reference(q, k, v, mask), iters=50)
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask[:, None, None, :]), iters=50)
    return dict(name=kernel.__name__, case=label, shape=[b, h, c, d],
                dtype=DTYPE_NAMES[dtype], max_abs_err=err, atol=ATOL[dtype],
                bit_identical=torch.equal(out, again),
                cluster=(decode_cluster_size(b, h, c, d, dtype, dev)
                         if on_card and not wide else None),
                ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=bms, bound_by=by)


def _sdpa_backward_ms(q, k, v, g, mask, causal):
    """The yardstick of the backward pair: one backward of
    `F.scaled_dot_product_attention` at the same shape and mask (dQ, dK and
    dV together), timed alone on a retained graph."""
    qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
    am = None if mask is None else mask[:, None, None, :]
    out = F.scaled_dot_product_attention(qq, kk, vv, attn_mask=am,
                                         is_causal=causal)
    return time_ms(lambda: torch.autograd.grad(out, (qq, kk, vv), g,
                                               retain_graph=True))


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _bwd_cases(label, b, h, tq, tk, d, causal, lengths, dtype, gen):
    """Both backward kernels on one input: each against its plain version,
    re-run for bit identity, timed beside its plain version, the SDPA
    backward and its bound. Self-attention cases (`lengths` and Tq == Tk)
    mask queries and keys alike, as BERT does; the cross case masks keys
    only."""
    dev = torch.device(DEV)
    q = _randn(gen, dtype, b, h, tq, d)
    k = _randn(gen, dtype, b, h, tk, d)
    v = _randn(gen, dtype, b, h, tk, d)
    g = _randn(gen, dtype, b, h, tq, d)
    mask = None if lengths is None else _ragged_mask(lengths, tk, dev)
    qmask = mask if tq == tk else None
    o, lse = _flash_forward(q, k, v, qmask, mask, causal)
    args = (q, k, v, g, lse, _delta(g, o), mask, causal)
    # the plain versions in f64 on the same inputs: how far the kernels are
    # from exact, a yardstick that does not share the f32 plain version's
    # rounding (the two can agree bit for bit)
    args64 = tuple(t.double() if torch.is_tensor(t) and t.is_floating_point()
                   else t for t in args)
    lib = _sdpa_backward_ms(q, k, v, g, mask, causal)
    rows = []
    for name, kernel, plain in (("flash_bwd_dq", flash_bwd_dq, _dq_reference),
                                ("flash_bwd_dkv", flash_bwd_dkv,
                                 _dkv_reference)):
        got, again = _as_tuple(kernel(*args)), _as_tuple(kernel(*args))
        want = _as_tuple(plain(*args))
        exact = _as_tuple(plain(*args64))
        torch.cuda.synchronize()
        err = max((a.float() - w.float()).abs().max().item()
                  for a, w in zip(got, want))
        f64_err = max((a.double() - w).abs().max().item()
                      for a, w in zip(got, exact))
        plain_f64_err = max((a.double() - w).abs().max().item()
                            for a, w in zip(want, exact))
        del exact
        scale = max([1.0] + [w.float().abs().max().item() for w in want])
        identical = all(torch.equal(a, c) for a, c in zip(got, again))
        padded = [i for i, n in enumerate(lengths or []) if n == 0]
        leak = any(a[i].abs().max().item() != 0 for a in got for i in padded)
        bms, by = _flash_bound(name, b, h, tq, tk, d, causal, mask, dtype)
        rows.append(dict(
            name=name, case=label, shape=[b, h, tq, tk, d],
            dtype=DTYPE_NAMES[dtype], causal=causal, max_abs_err=err,
            atol=ATOL[dtype] * scale, f64_err=f64_err,
            plain_f64_err=plain_f64_err, bit_identical=identical,
            padded_example_zero=not leak, ms=time_ms(lambda: kernel(*args)),
            plain_ms=time_ms(lambda: plain(*args)), library_ms=lib,
            bound_ms=bms, bound_by=by))
    return rows


#: the attention layers' kernel shapes (B, H, Tq, Tk, D) with their key
#: lengths: the example stack's self-attention and learned queries at D = 8
#: (B = 256, T = 24, lengths 8-24), the long_context_bert twin's ring
#: block on one rank (bert_tiny: B = 2, 4 heads of D = 8, T = 64, no
#: padding: full tiles), and a 512-wide layer of 4 heads at D = 128
#: (B = 16, T = 512)
ATTN_KERNEL_SHAPES = (
    ("attn D=8", (256, 4, 24, 24, 8),
     [8 + (i * 7) % 17 for i in range(256)]),
    ("learned Tq=4 D=8", (256, 4, 4, 24, 8),
     [8 + (i * 7) % 17 for i in range(256)]),
    ("long_context_bert D=8", (2, 4, 64, 64, 8), None),
    ("attn D=128", (16, 4, 512, 512, 128),
     [512 - 31 * i for i in range(16)]),
    # DL4J's default single head: the one-head path's stack at nOut = 256
    # (self-attention and its learned queries, Tq = 4) and the wide layer
    # at nOut = 512, each head dim a wide kernel's (128 columns a block)
    ("attn D=256", (32, 1, 512, 512, 256),
     [512 - 13 * i for i in range(32)]),
    ("learned Tq=4 D=256", (32, 1, 4, 512, 256),
     [512 - 13 * i for i in range(32)]),
    ("attn D=512", (16, 1, 512, 512, 512),
     [512 - 31 * i for i in range(16)]))
#: the widest head dim checked: one forward, eight 128-column chunks
FWD_1024 = ("D=1024 fwd", (1, 1, 128, 128, 1024))
#: flash_decode at the instantiations this slice added, at the serving
#: shapes that reach them: bert_tiny's D = 8 (8 slots x 4 heads), D = 16,
#: and BERT-base width at 3 heads (D = 256, 8 slots x 3 heads, C = 512);
#: and past its widest, a one-head decoder at nOut = 1536 (8 slots,
#: C = 512), which runs flash_fwd with one query row
DECODE_HEAD_DIMS = (("decode D=8", 8, 4, 128, 8), ("decode D=16", 8, 4, 128, 16),
                    ("decode D=256 C=512", 8, 3, 512, 256),
                    ("decode D=1536", 8, 1, 512, 1536))
#: the kernel rows of the head dims this slice added (the kernels line's
#: `head_dims` and PERF.md's rows)
HEAD_DIM_CASES = tuple(c[0] for c in ATTN_KERNEL_SHAPES[4:]) + (
    FWD_1024[0],) + tuple(c[0] for c in DECODE_HEAD_DIMS)


#: the flash ring's block in the parallel phase's recipe (B, H, Tq, Tk, D):
#: BERT-base at T = 4096 over sp = 2
RING_BLOCK = (2, 12, 2048, 2048, 64)
#: the 1×1 convs whose shapes the epilogue GEMM is checked at, ResNet-50
#: at 224×224 and B=32: (M = B·H·W, K, N), and one ragged M (and K) with
#: a residual and relu
EPILOGUE_SHAPES = {"res2_c B=32": (32 * 56 * 56, 64, 256),
                   "res4_a B=32": (32 * 14 * 14, 1024, 256),
                   "res5_c B=32": (32 * 7 * 7, 512, 2048),
                   "ragged+res+relu": (4999, 1000, 256)}
#: the int8 epilogue GEMM's cases: three 1×1 convs of ResNet-50 at B=32 and
#: a ragged one (K % 16 and N % 8 not 0: rows copied byte by byte) with a
#: residual and bf16 out: (M, K, N, residual and bf16 out)
INT8_SHAPES = {"res2_c B=32": (32 * 56 * 56, 64, 256, False),
               "res4_a B=32": (32 * 14 * 14, 1024, 256, False),
               "res5_c B=32": (32 * 7 * 7, 512, 2048, False),
               "ragged+res bf16": (4999, 1000, 251, True)}
#: the zoo's graph models' conv1x1+BN pair shapes (M, K, N) on the zoo
#: phase's path, with the dtypes each runs in: InceptionResNetV1's three at
#: 160×160, B=32 (stem3: 1 pair; block35's b0/b1a/b2a: 15; block17's
#: b0/b1a: 20; the BN takes relu) and NASNet's N = 44 at 224×224, B=8 in
#: bf16 (44·2 bytes is no multiple of 16: the unvectorised loads)
ZOO_PAIR_SHAPES = {"irv1 stem3 B=32": ((51200, 64, 128),
                                       (torch.float32, torch.bfloat16)),
                   "irv1 block35 B=32": ((12800, 256, 32),
                                         (torch.float32, torch.bfloat16)),
                   "irv1 block17 B=32": ((3200, 512, 128),
                                         (torch.float32, torch.bfloat16)),
                   "nasnet N=44 B=8": ((100352, 132, 44),
                                       (torch.bfloat16,))}
#: MobileNetV2's narrowest and widest conv1x1+BN pairs at 224×224, B=32
#: (the keras phase's path), f32: (M, K, N)
MOBILENET_PAIR_SHAPES = {"mnv2 expanded_conv_project": (401408, 32, 16),
                         "mnv2 block_1_expand": (401408, 16, 96),
                         "mnv2 block_16_project": (1568, 960, 320),
                         "mnv2 Conv_1": (1568, 320, 1280)}
#: ResNet-50's identity blocks at B=32: (B, H, W, C, M)
BOTTLENECK_SHAPES = {"res2 B=32": (32, 56, 56, 256, 64),
                     "res3 B=32": (32, 28, 28, 512, 128),
                     "res4 B=32": (32, 14, 14, 1024, 256),
                     "res5 B=32": (32, 7, 7, 2048, 512)}


def _scaled_err(got, want):
    """max |got − want| and max(1, max |want|)."""
    err = (got.float() - want.float()).abs().max().item()
    return err, max(1.0, want.float().abs().max().item())


def _fwd_work(m, k, n, dtype, nbytes, extra_flops=0.0):
    """(operations, bytes, peak) of a forward GEMM (matmul_epilogue,
    matmul_stats) on its tensor-core route: f32 as 3×TF32 (three TF32
    products of 2·M·K·N each) at the TF32 rate, bf16 at the bf16 rate."""
    if dtype == torch.float32:
        return 6.0 * m * k * n + extra_flops, nbytes, PEAK_TF32
    return 2.0 * m * k * n + extra_flops, nbytes, None


def _tile(m, k, n, int8=False):
    """The tile the forward GEMMs' launch picks on the card, "BMxBN"."""
    return ("x".join(map(str, _fwd_tile(m, k, n, int8))) if DEV == "cuda"
            else None)


def _epilogue_case(label, m, k, n, with_res, act, dtype, gen, iters=20):
    """matmul_epilogue against its plain version, timed beside it, beside
    cuBLAS's product with the same epilogue in PyTorch, and its bound."""
    x = _randn(gen, dtype, m, k)
    w = (torch.randn((k, n), generator=gen, device=DEV) / k ** 0.5).to(
        dtype)
    scale = torch.rand(n, generator=gen, device=DEV) + 0.5
    shift = torch.randn(n, generator=gen, device=DEV) * 0.1
    res = _randn(gen, dtype, m, n) if with_res else None
    out = matmul_epilogue(x, w, scale, shift, residual=res, act=act)
    ref = _epilogue_reference(x, w, scale, shift, res, act, dtype)
    torch.cuda.synchronize()
    err, scl = _scaled_err(out, ref)
    esz = x.element_size()
    nbytes = (m * k + k * n + m * n * (2 if with_res else 1)) * esz + 8 * n
    flops, nbytes, peak = _fwd_work(m, k, n, dtype, nbytes)
    bms, by = bound(flops, nbytes, dtype, peak)

    def library():
        y = torch.matmul(x, w) * scale + shift
        if res is not None:
            y = y + res
        return torch.relu(y) if act == "relu" else y

    return dict(
        name="matmul_epilogue", case=label, shape=[m, k, n],
        dtype=DTYPE_NAMES[dtype], act=act, tile=_tile(m, k, n),
        max_abs_err=err, atol=ATOL[dtype] * scl,
        ms=time_ms(lambda: matmul_epilogue(x, w, scale, shift, residual=res,
                                           act=act), iters),
        plain_ms=time_ms(lambda: _epilogue_reference(x, w, scale, shift, res,
                                                     act, dtype), iters),
        library_ms=time_ms(library, iters), bound_ms=bms, bound_by=by)


def _int8_case(label, m, k, n, ragged, gen):
    """int8_matmul_epilogue: the int32 sums bit-exact (scale 1, shift 0
    against the exact product), then the epilogue (relu; with a residual
    and bf16 out where `ragged`) within INT8_RTOL of the largest f32
    output (one rounding of acc·scale + shift apart), or ATOL[bf16] of it
    in bf16 (the output's rounding). The yardstick is torch._int_mm
    (cuBLAS int8) with the same epilogue."""
    def ints(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=DEV,
                             dtype=torch.int32).to(torch.int8)

    xq, wq = ints(m, k), ints(k, n)
    scale = (torch.rand(n, generator=gen, device=DEV) + 0.5) * 1e-3
    shift = torch.randn(n, generator=gen, device=DEV)
    out_dtype = torch.bfloat16 if ragged else torch.float32
    res = _randn(gen, out_dtype, m, n) if ragged else None
    ones = torch.ones(n, device=DEV)
    acc = int8_matmul_epilogue(xq, wq, ones, torch.zeros_like(ones))
    exact = (xq.double() @ wq.double()).float()

    def kernel():
        return int8_matmul_epilogue(xq, wq, scale, shift, residual=res,
                                    act="relu", out_dtype=out_dtype)

    def plain():
        return _epilogue_reference(xq, wq, scale, shift, res, "relu",
                                   out_dtype)

    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    acc_exact = bool(torch.equal(acc, exact))
    err, scl = _scaled_err(out, ref)
    atol = (ATOL[torch.bfloat16] * scl if ragged
            else INT8_RTOL * ref.abs().max().item())
    osz = 2 if ragged else 4
    nbytes = m * k + k * n + osz * m * n * (2 if ragged else 1) + 8 * n
    bms, by = bound(2.0 * m * k * n, nbytes, torch.int8)

    def library():
        y = torch._int_mm(xq, wq).float() * scale + shift
        if res is not None:
            y = y + res
        return torch.relu(y).to(out_dtype)

    try:
        library()
        lib = time_ms(library)
    except RuntimeError as e:      # the yardstick only; not the port
        log(f"[kernels] torch._int_mm unavailable at {[m, k, n]}: {e}")
        lib = None
    return dict(
        name="int8_matmul_epilogue", case=label, shape=[m, k, n],
        dtype="int8", out_dtype=DTYPE_NAMES[out_dtype],
        tile=_tile(m, k, n, int8=True), max_abs_err=err,
        acc_exact=acc_exact, atol=atol, ms=time_ms(kernel),
        plain_ms=time_ms(plain), library_ms=lib, bound_ms=bms, bound_by=by)


def _bottleneck_library(x, w1, b1, w2, b2, w3, b3):
    """The block as three cuDNN convolutions in the activation dtype
    (channels-last; bf16 on the tensor cores): the yardstick."""
    cl = torch.channels_last
    xc = x.permute(0, 3, 1, 2)

    def conv(t, w, pad):
        return F.conv2d(t, w.permute(3, 2, 0, 1).contiguous(
            memory_format=cl), padding=pad)

    h1 = torch.relu(conv(xc, w1[None, None], 0)
                    + b1.to(x.dtype)[None, :, None, None])
    h2 = torch.relu(conv(h1, w2, 1) + b2.to(x.dtype)[None, :, None, None])
    y = conv(h2, w3[None, None], 0) + b3.to(x.dtype)[None, :, None, None]
    return torch.relu(y + xc).permute(0, 2, 3, 1)


def _bottleneck_weights(c, m, dtype, gen):
    """Folded-BN weights of one identity block, scaled so the activations
    stay O(1) through it."""
    def rnd(*shape, std):
        return (torch.randn(shape, generator=gen, device=DEV) * std).to(dtype)

    return (rnd(c, m, std=(2 / c) ** 0.5),
            torch.randn(m, generator=gen, device=DEV) * 0.1,
            rnd(3, 3, m, m, std=(2 / (9 * m)) ** 0.5),
            torch.randn(m, generator=gen, device=DEV) * 0.1,
            rnd(m, c, std=0.5 / m ** 0.5),
            torch.randn(c, generator=gen, device=DEV) * 0.1)


def _bottleneck_work(b, h, w, c, m, esz):
    """(operations, bytes, peak) of the block on its tensor-core route: f32
    as 3×TF32 (three TF32 products each) at the TF32 rate, bf16 at the bf16
    rate; bytes are x, y and the weights once, and the f32 biases."""
    flops = 2.0 * b * h * w * (c * m + 9 * m * m + m * c)
    nbytes = 2 * b * h * w * c * esz + (2 * c * m + 9 * m * m) * esz \
        + (2 * m + c) * 4
    if esz == 4:
        return 3.0 * flops, nbytes, PEAK_TF32
    return flops, nbytes, None


def _block_plan(b, h, w, c, m, dtype):
    """The launch's plan (R, pixels, blocks, mi, smem) and the L2 weight
    bytes it implies: every block streams all 17·M² weight values."""
    if DEV != "cuda":
        return None
    plan = _block_plan_of(dtype, b, h, w, c, m)
    esz = torch.tensor([], dtype=dtype).element_size()
    plan["l2_weight_bytes"] = plan["blocks"] * 17 * m * m * esz
    return plan


def _bottleneck_case(label, b, h, w, c, m, dtype, gen):
    x = torch.relu(_randn(gen, dtype, b, h, w, c))
    wts = _bottleneck_weights(c, m, dtype, gen)
    args = (x, wts[0], wts[1], wts[2], wts[3], wts[4], wts[5])
    out = bottleneck_block(*args, block_b=1)
    again = bottleneck_block(*args, block_b=1)
    ref = bottleneck_block_xla(*args)
    torch.cuda.synchronize()
    err, scl = _scaled_err(out, ref)
    flops, nbytes, peak = _bottleneck_work(b, h, w, c, m, x.element_size())
    bms, by = bound(flops, nbytes, dtype, peak)
    return dict(
        name="bottleneck_block", case=label, shape=[b, h, w, c, m],
        dtype=DTYPE_NAMES[dtype], max_abs_err=err, atol=ATOL[dtype] * scl,
        bit_identical=bool(torch.equal(out, again)),
        plan=_block_plan(b, h, w, c, m, dtype),
        fma_bound_ms=(bound(flops / 3, nbytes, dtype)[0] if peak else None),
        ms=time_ms(lambda: bottleneck_block(*args, block_b=1), iters=10),
        plain_ms=time_ms(lambda: bottleneck_block_xla(*args), iters=10),
        library_ms=time_ms(lambda: _bottleneck_library(*args), iters=10),
        bound_ms=bms, bound_by=by)


#: the shapes the training path gives the three BN-training kernels
#: (ResNet-50 at 224×224 and B=32, (M, K, N)) and one ragged case
BN_TRAIN_SHAPES = {"res2_c B=32": (32 * 56 * 56, 64, 256),
                   "res4_a B=32": (32 * 14 * 14, 1024, 256),
                   "res5_c B=32": (32 * 7 * 7, 512, 2048),
                   "ragged": (4999, 200, 1000)}
#: fused_layernorm at BERT-base's rows (B=32 × T=128, D=768) and a ragged
#: (rows, D)
LAYERNORM_SHAPES = {"bert_base 4096x768": (4096, 768),
                    "ragged 4999x1000": (4999, 1000)}


def _worst(got, want, atol):
    """Over pairs of outputs: (max |got − want| of the output nearest its
    tolerance, that output's tolerance atol × max(1, max |want|), all
    within)."""
    best = None
    for a, b in zip(got, want):
        err, scl = _scaled_err(a, b)
        if best is None or err / scl > best[0] / best[1]:
            best = (err, scl)
    return best[0], atol * best[1]


def _kernel_row(name, label, shape, dtype, kernel, plain, library, work,
                iters=20, peak=None):
    """Run a kernel and its plain version on the same inputs: the largest
    error against the tolerance, a re-run for bit identity, and the times
    of the kernel, the plain version and the library yardstick beside the
    bound."""
    got, again, want = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    err, atol = _worst(got, want, ATOL[dtype])
    identical = all(torch.equal(a, b) for a, b in zip(got, again))
    bms, by = bound(*work, dtype, peak)
    return dict(name=name, case=label, shape=list(shape),
                dtype=DTYPE_NAMES[dtype], max_abs_err=err, atol=atol,
                bit_identical=identical, ms=time_ms(kernel, iters),
                plain_ms=time_ms(plain, iters),
                library_ms=time_ms(library, iters), bound_ms=bms,
                bound_by=by)


def _stats_case(label, m, k, n, dtype, gen, iters=20):
    """matmul_stats (row 5); the yardstick is cuBLAS's product and two
    PyTorch sums over it. The bound is the route's (_fwd_work)."""
    x = _randn(gen, dtype, m, k)
    w = (torch.randn((k, n), generator=gen, device=DEV) / k ** 0.5).to(dtype)

    def library():
        yf = torch.matmul(x, w).float()
        return yf.sum(0), (yf * yf).sum(0)

    esz = x.element_size()
    *work, peak = _fwd_work(m, k, n, dtype,
                            (m * k + k * n + m * n) * esz + 8 * n,
                            3.0 * m * n)
    row = _kernel_row(
        "matmul_stats", label, (m, k, n), dtype, lambda: matmul_stats(x, w),
        lambda: _matmul_stats_reference(x, w), library, work, iters, peak)
    row["tile"] = _tile(m, k, n)
    return row


def _bn_vectors(n, gen):
    """μ, and r = 1/√(var + ε), of a batch of BN inputs."""
    return (torch.randn(n, generator=gen, device=DEV) * 0.1,
            torch.rand(n, generator=gen, device=DEV) + 0.5)


def _grad_stats_case(label, m, k, n, dtype, gen):
    """bn_grad_stats (row 7); the yardstick is the two PyTorch sums."""
    y, dz = _randn(gen, dtype, m, n), _randn(gen, dtype, m, n)
    mu, r = _bn_vectors(n, gen)

    def library():
        dzf = dz.float()
        return (dzf * ((y.float() - mu) * r)).sum(0), dzf.sum(0)

    return _kernel_row(
        "bn_grad_stats", label, (m, n), dtype,
        lambda: bn_grad_stats(y, dz, mu, r),
        lambda: _bn_grad_stats_reference(y, dz, mu, r), library,
        (4.0 * m * n, 2 * m * n * y.element_size() + 16 * n))


def _conv_grads_work(m, k, n, esz):
    """(operations, bytes, peak) of bn_conv_grads on its route: f32 as
    3×TF32 (three TF32 products of 4·M·K·N each) on the TF32 tensor cores,
    bf16 on the bf16 ones; x, y, dz, w read once, dX and dW written once."""
    flops = 4.0 * m * k * n * (3 if esz == 4 else 1) + 5.0 * m * n
    nbytes = (2 * m * k + 2 * m * n + k * n) * esz + 4 * k * n + 16 * n
    return flops, nbytes, (PEAK_TF32 if esz == 4 else None)


def _conv_grads_case(label, m, k, n, dtype, gen, iters=20):
    """bn_conv_grads (row 8); the yardstick is the dy pass in PyTorch and
    cuBLAS's two products."""
    x = _randn(gen, dtype, m, k)
    y, dz = _randn(gen, dtype, m, n), _randn(gen, dtype, m, n)
    w = (torch.randn((k, n), generator=gen, device=DEV) / n ** 0.5).to(dtype)
    mu, r = _bn_vectors(n, gen)
    k1 = torch.rand(n, generator=gen, device=DEV) + 0.5
    k2 = k1 * r * torch.randn(n, generator=gen, device=DEV) * 1e-3
    c = k1 * torch.randn(n, generator=gen, device=DEV) * 1e-3
    args = (x, y, dz, w, k1, k2, c, mu)

    def library():
        dy = _bn_dy(y, dz, k1, k2, c, mu, dtype).to(dtype)
        return dy @ w.T, x.T @ dy

    *work, peak = _conv_grads_work(m, k, n, x.element_size())
    return _kernel_row(
        "bn_conv_grads", label, (m, k, n), dtype,
        lambda: bn_conv_grads(*args),
        lambda: _bn_conv_grads_reference(*args), library, work, iters, peak)


#: the 36 conv1x1+BN pairs of one ResNet-50 training step at B=32, 224×224:
#: (M, K, N) -> pairs of that shape (M = 32·H·W; res2 56², res3 28², res4
#: 14², res5 7²)
STEP36 = {(100352, 64, 256): 4, (100352, 256, 64): 2, (100352, 64, 64): 1,
          (25088, 128, 512): 4, (25088, 512, 128): 3, (25088, 256, 128): 1,
          (25088, 256, 512): 1,
          (6272, 256, 1024): 6, (6272, 1024, 256): 5, (6272, 512, 256): 1,
          (6272, 512, 1024): 1,
          (1568, 512, 2048): 3, (1568, 2048, 512): 2, (1568, 1024, 512): 1,
          (1568, 1024, 2048): 1}


def step36_cases():
    """bn_conv_grads at each of the step's 15 shapes, f32, each checked
    against its plain version (10 timed calls each)."""
    case = functools.partial(_conv_grads_case, iters=10)
    return [(case, f"step36 {m}x{k}x{n}", m, k, n, torch.float32)
            for (m, k, n) in STEP36]


def step36_summary(rows):
    """The step's bn_conv_grads: kernel and library ms summed over the 36
    pairs (each shape's time × its count), beside the step's bound: the
    larger of its bytes over the memory rate and its 3×TF32 operations over
    the TF32 rate, each summed over the pairs."""
    got = {tuple(r["shape"]): r for r in rows
           if r["name"] == "bn_conv_grads" and r["case"].startswith("step36")}
    flops = nbytes = 0.0
    for (m, k, n), count in STEP36.items():
        f, b, _ = _conv_grads_work(m, k, n, 4)
        flops, nbytes = flops + count * f, nbytes + count * b
    out = {"pairs": sum(STEP36.values()), "shapes": len(got),
           "kernel_ms": sum(c * got[s]["ms"] for s, c in STEP36.items()),
           "library_ms": sum(c * got[s]["library_ms"]
                             for s, c in STEP36.items()),
           "plain_ms": sum(c * got[s]["plain_ms"] for s, c in STEP36.items()),
           "bound_ms": max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_TF32) * 1e3,
           "bound_by": ("bytes" if nbytes / PEAK_BYTES_PER_S
                        >= flops / PEAK_TF32 else "operations"),
           "worst_err_over_atol": max(got[s]["max_abs_err"] / got[s]["atol"]
                                      for s in STEP36),
           "bit_identical": all(got[s]["bit_identical"] for s in STEP36)}
    log(f"[kernels] bn_conv_grads step36 ({out['pairs']} pairs, "
        f"{out['shapes']} shapes, f32): kernel_ms={out['kernel_ms']:.4f} "
        f"library_ms={out['library_ms']:.4f} plain_ms={out['plain_ms']:.4f} "
        f"bound_ms={out['bound_ms']:.4f} ({out['bound_by']}) "
        f"worst err/atol={out['worst_err_over_atol']:.3f} "
        f"bit_identical={out['bit_identical']}")
    return out


#: the forward kernels' kernel-phase cases over STEP36: f32, the dtype of
#: both main paths, and bf16
FWD36_DTYPES = (torch.float32, torch.bfloat16)


def fwd36_cases():
    """matmul_epilogue and matmul_stats at each of STEP36's 15 shapes (the
    36 conv1x1+BN pairs of one ResNet-50 forward), in f32 and bf16, each
    checked against its plain version (10 timed calls each). The epilogue
    takes relu where the pair's BN does: the 16 `_a` convs, which narrow
    the channels (N ≤ K); the `_c` and shortcut convs are identity."""
    cases = []
    for dtype in FWD36_DTYPES:
        for (m, k, n) in STEP36:
            label = f"fwd36 {m}x{k}x{n}"
            cases.append((functools.partial(_epilogue_case, iters=10), label,
                          m, k, n, False, "relu" if n <= k else "identity",
                          dtype))
            cases.append((functools.partial(_stats_case, iters=10), label,
                          m, k, n, dtype))
    return cases


def fwd36_summary(rows):
    """Each forward kernel over one ResNet-50 forward's 36 pairs, per
    dtype: kernel, library and plain ms summed over the pairs (each shape's
    time × its count), beside the bound summed the same way (each shape's
    larger of bytes at the memory rate and operations at its route's
    rate)."""
    out = {}
    for name in ("matmul_epilogue", "matmul_stats"):
        for dtype in FWD36_DTYPES:
            dt = DTYPE_NAMES[dtype]
            got = {tuple(r["shape"]): r for r in rows
                   if r["name"] == name and r["dtype"] == dt
                   and r["case"].startswith("fwd36")}

            def total(key):
                return sum(c * got[s][key] for s, c in STEP36.items())

            s = {"pairs": sum(STEP36.values()), "shapes": len(got),
                 "kernel_ms": total("ms"), "library_ms": total("library_ms"),
                 "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
                 "worst_err_over_atol": max(
                     got[sh]["max_abs_err"] / got[sh]["atol"]
                     for sh in STEP36),
                 "shapes_slower_than_library": [
                     list(sh) for sh in STEP36
                     if got[sh]["ms"] > got[sh]["library_ms"]],
                 "tiles": {"x".join(map(str, sh)): got[sh]["tile"]
                           for sh in STEP36}}
            if name == "matmul_stats":
                s["bit_identical"] = all(got[sh]["bit_identical"]
                                         for sh in STEP36)
            out[f"{name} {dt}"] = s
            log(f"[kernels] {name} fwd36 ({s['pairs']} pairs, "
                f"{s['shapes']} shapes, {dt}): "
                f"kernel_ms={s['kernel_ms']:.4f} "
                f"library_ms={s['library_ms']:.4f} "
                f"plain_ms={s['plain_ms']:.4f} bound_ms={s['bound_ms']:.4f} "
                f"worst err/atol={s['worst_err_over_atol']:.3f} "
                f"slower than library at "
                f"{len(s['shapes_slower_than_library'])} shapes"
                + (f" bit_identical={s['bit_identical']}"
                   if "bit_identical" in s else ""))
    return out


#: the fine-tune step's attention: each of its 12 layers launches flash_fwd,
#: flash_bwd_dq and flash_bwd_dkv once at this kernel-phase case
STEP12_CASE = "train B=32 T=128"


def bert_step12_summary(rows):
    """The fine-tune step's three attention kernels per dtype: 12 × (fwd +
    dQ + dK/dV) kernel ms at the step's shape, against 12 × (SDPA forward +
    SDPA backward), beside 12 × the three bounds."""
    out = {}
    for dt in ("f32", "bf16"):
        got = {r["name"]: r for r in rows
               if r["case"] == STEP12_CASE and r["dtype"] == dt}
        names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
        s = {"layers": 12,
             "kernel_ms": 12 * sum(got[n]["ms"] for n in names),
             "library_ms": 12 * (got["flash_fwd"]["library_ms"]
                                 + got["flash_bwd_dq"]["library_ms"]),
             "bound_ms": 12 * sum(got[n]["bound_ms"] for n in names),
             "by_kernel_ms": {n: 12 * got[n]["ms"] for n in names}}
        out[dt] = s
        log(f"[kernels] bert_step12 ({dt}, 12 layers at {STEP12_CASE}): "
            f"kernel_ms={s['kernel_ms']:.4f} (fwd "
            f"{s['by_kernel_ms']['flash_fwd']:.4f} + dQ "
            f"{s['by_kernel_ms']['flash_bwd_dq']:.4f} + dK/dV "
            f"{s['by_kernel_ms']['flash_bwd_dkv']:.4f}) "
            f"library_ms={s['library_ms']:.4f} (SDPA forward + backward) "
            f"bound_ms={s['bound_ms']:.5f}")
    return out


def _layernorm_case(label, rows, d, dtype, gen):
    """fused_layernorm's kernel (row 4); the yardstick is F.layer_norm."""
    x = _randn(gen, dtype, rows, d) * 2 + 0.5
    g = torch.rand(d, generator=gen, device=DEV) + 0.5
    b = torch.randn(d, generator=gen, device=DEV) * 0.1
    gd, bd = g.to(dtype), b.to(dtype)
    return _kernel_row(
        "fused_layernorm", label, (rows, d), dtype,
        lambda: (fused_layernorm(x, g, b),),
        lambda: _layernorm_reference(x, g, b, 1e-5)[:1],
        lambda: F.layer_norm(x, (d,), gd, bd, 1e-5),
        (8.0 * rows * d, 2 * rows * d * x.element_size() + 8 * d + 8 * rows))


def training_kernel_cases(dtype):
    """The cases of the four kernels of the ResNet-50 training slice."""
    cases = []
    for label, (m, k, n) in BN_TRAIN_SHAPES.items():
        for fn in (_stats_case, _grad_stats_case, _conv_grads_case):
            cases.append((fn, label, m, k, n, dtype))
    for label, (rows, d) in LAYERNORM_SHAPES.items():
        cases.append((_layernorm_case, label, rows, d, dtype))
    return cases


def run_kernel_cases(cases, gen):
    """Run each case and log its row; raises if any kernel disagrees with
    its plain version (or re-runs other bits). Returns the rows."""
    rows = []
    for fn, *a in cases:
        t = time.perf_counter()
        got = fn(*a, gen)
        for r in got if isinstance(got, list) else [got]:
            r["wall_s"] = time.perf_counter() - t   # the whole case's
            rows.append(r)
    bad = []
    for r in rows:
        ok = (r["max_abs_err"] <= r["atol"] and r.get("bit_identical", True)
              and r.get("padded_example_zero", True)
              and r.get("acc_exact", True))
        lib = r["library_ms"]
        log(f"[kernels] {r['name']:<12} {r['case']:<14} "
            f"shape={r['shape']} {r['dtype']:<4} "
            f"max_abs_err={r['max_abs_err']:.3e} (atol {r['atol']:.2e}) "
            f"{'ok' if ok else 'FAIL'}  ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} library_ms="
            + ("none" if lib is None else f"{lib:.4f}")
            + f" bound_ms={r['bound_ms']:.5f} ({r['bound_by']}) "
            f"case_s={r['wall_s']:.2f}"
            + ("" if "bit_identical" not in r else
               f" bit_identical={r['bit_identical']}")
            + ("" if "f64_err" not in r else f" f64_err={r['f64_err']:.3e}"
               f" plain_f64_err={r['plain_f64_err']:.3e}")
            + ("" if "cluster" not in r else f" cluster={r['cluster']}")
            + ("" if "acc_exact" not in r else
               f" int32_sums_exact={r['acc_exact']}")
            + ("" if not r.get("tile") or r["name"] != "int8_matmul_epilogue"
               else f" tile={r['tile']}")
            + ("" if not r.get("plan") else
               " R={rows} P={pixels} blocks={blocks} mi={mi} smem={smem} "
               "l2_weight_bytes={l2_weight_bytes}".format(**r["plan"]))
            + ("" if not r.get("fma_bound_ms") else
               f" fma_rate_bound_ms={r['fma_bound_ms']:.5f}"))
        if not ok:
            bad.append(f"{r['name']} {r['case']} {r['dtype']}")
    if bad:
        raise AssertionError(f"kernels disagree with their plain "
                             f"versions: {bad}")
    return rows


def phase_kernels():
    """Every kernel against its plain version; returns (rows, launches of
    each kernel in this phase)."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    _reset_counts()
    enc_lens = [512, 300, 128, 1, 0, 77, 450, 511]   # one fully padded
    train_lens = _train_lengths(TRAIN["batch"], TRAIN["seq"])
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        cases.append((_fwd_case, "encode", 8, 12, 512, 512, 64, False,
                      enc_lens, dtype))
        cases.append((_fwd_case, "encode T=128", 8, 12, 128, 128, 64, False,
                      ENCODE_LENS, dtype))
        for p in (16, 128):
            cases.append((_fwd_case, f"prefill P={p}", 1, 12, p, p, 64, True,
                          None, dtype))
        cases.append((_fwd_case, "cross Tq!=Tk", 2, 12, 100, 300, 64, False,
                      [300, 171], dtype))
        cases.append((_fwd_case, "train B=32 T=128", 32, 12, 128, 128, 64,
                      False, train_lens, dtype))
        for c in (128, 512):
            lens = [c, c // 2, 1, 0, 37, c - 1, 64, 100]  # one empty row
            cases.append((_decode_case, f"decode C={c}", 8, 12, c, 64, lens,
                          dtype))
        cases.append((_bwd_cases, "train B=32 T=128", 32, 12, 128, 128, 64,
                      False, train_lens, dtype))
        cases.append((_bwd_cases, "encode", 8, 12, 512, 512, 64, False,
                      enc_lens, dtype))
        cases.append((_bwd_cases, "causal T=128", 1, 12, 128, 128, 64, True,
                      None, dtype))
        cases.append((_bwd_cases, "cross Tq!=Tk", 2, 12, 100, 300, 64, False,
                      [300, 171], dtype))
        # the attention layers' head dims: the example's D = 8 (run padded
        # to 16; its learned queries cross-attend, Tq = 4), the
        # long-context twin's unpadded ring block at D = 8 and D = 128
        for label, shape, lens in ATTN_KERNEL_SHAPES:
            cases.append((_fwd_case, label, *shape, False, lens, dtype))
            cases.append((_bwd_cases, label, *shape, False, lens, dtype))
        cases.append((_fwd_case, FWD_1024[0], *FWD_1024[1], False, None,
                      dtype))
        for label, b, h, c, d in DECODE_HEAD_DIMS:
            lens = [c, c // 2, 1, 0, 37, c - 1, 64, 100]   # one empty row
            cases.append((_decode_case, label, b, h, c, d, lens, dtype))
        for label, (m, k, n) in EPILOGUE_SHAPES.items():
            ragged = label.startswith("ragged")
            cases.append((_epilogue_case, label, m, k, n, ragged,
                          "relu" if ragged else "identity", dtype))
        for label, shape in BOTTLENECK_SHAPES.items():
            cases.append((_bottleneck_case, label, *shape, dtype))
        cases += training_kernel_cases(dtype)
    for label, shape in INT8_SHAPES.items():
        cases.append((_int8_case, label, *shape))
    for causal in (False, True):
        # the flash ring's block at the long-context recipe's shape: one
        # rank's 2048 queries against one held block of 2048 keys
        label = "ring block causal" if causal else "ring block"
        cases.append((_fwd_case, label, *RING_BLOCK, causal,
                      None, torch.float32))
        cases.append((_bwd_cases, label, *RING_BLOCK, causal,
                      None, torch.float32))
    cases += step36_cases()
    cases += fwd36_cases()
    cases += zoo_pair_cases()
    return run_kernel_cases(cases, gen), _counts()


def zoo_pair_cases():
    """The four pair kernels at ZOO_PAIR_SHAPES and, in f32, at
    MOBILENET_PAIR_SHAPES: the epilogue GEMM (relu), matmul_stats,
    bn_grad_stats and bn_conv_grads, each against its plain version at the
    kernel rows' gates (10 timed calls each)."""
    cases = []
    shapes = dict(ZOO_PAIR_SHAPES)
    shapes.update({label: (shape, (torch.float32,))
                   for label, shape in MOBILENET_PAIR_SHAPES.items()})
    for label, ((m, k, n), dtypes) in shapes.items():
        for dtype in dtypes:
            cases.append((functools.partial(_epilogue_case, iters=10), label,
                          m, k, n, False, "relu", dtype))
            cases.append((functools.partial(_stats_case, iters=10), label,
                          m, k, n, dtype))
            cases.append((_grad_stats_case, label, m, k, n, dtype))
            cases.append((functools.partial(_conv_grads_case, iters=10),
                          label, m, k, n, dtype))
    return cases


# -- phase 4 ------------------------------------------------------------------
KERNELS = (flash_fwd, flash_decode, flash_bwd_dq, flash_bwd_dkv,
           matmul_epilogue, int8_matmul_epilogue, bottleneck_block,
           matmul_stats, bn_grad_stats, bn_conv_grads, fused_layernorm)


def _reset_counts():
    for kernel in KERNELS:
        kernel.launches = 0


def _counts():
    return {kernel.__name__: kernel.launches for kernel in KERNELS}


def phase_encoder(cfg, params):
    dev = torch.device(DEV)
    rng = np.random.default_rng(1)
    b, t = 8, 128
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, t)),
                          device=dev)
    mask = _ragged_mask(ENCODE_LENS, t, dev)
    bert_classify(cfg, params, ids, attn_mask=mask)      # warm
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    logits = bert_classify(cfg, params, ids, attn_mask=mask)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches = _counts()
    dense = bert_classify(cfg, params, ids, attn_mask=mask,
                          attn_impl="dense")
    err = (logits - dense).abs().max().item()
    log(f"[encoder] bert_classify bert_base B={b} T={t} f32: "
        f"{wall:.2f} ms, flash_fwd launches {launches['flash_fwd']}, "
        f"max |flash - dense| = {err:.3e} (atol 1e-4)")
    if launches["flash_fwd"] != cfg.num_layers:
        raise AssertionError(f"encoder: flash_fwd launched "
                             f"{launches['flash_fwd']} times, expected "
                             f"{cfg.num_layers}")
    if not torch.isfinite(logits).all() or logits.shape != (b, 2):
        raise AssertionError(f"encoder: bad logits {logits.shape}")
    if err > 1e-4:
        raise AssertionError(f"encoder: flash vs dense differ by {err}")
    return {"wall_ms": wall, "max_abs_err": err, "launches": launches}


# -- phase 5 ------------------------------------------------------------------
SERVER = dict(slots=8, cache_lengths=[128, 512],
              prompt_buckets=[16, 32, 64, 128], superstep=4, seed=0)


def _requests(cfg):
    """12 requests: prompt lengths 5-120, 32-64 new tokens, greedy /
    temperature 0.8 / top-k 40 in turn; request 3 needs 120 + 64 rows, so
    its admission grows the cache from rung 128 to 512 mid-flight."""
    rng = np.random.default_rng(2)
    reqs = []
    for i in range(12):
        plen = 120 if i == 3 else int(rng.integers(5, 121))
        new = 64 if i == 3 else int(rng.integers(32, 65))
        mode = ("greedy", "temperature", "top_k")[i % 3]
        reqs.append(dict(prompt=rng.integers(1, cfg.vocab_size, plen),
                         max_new_tokens=new, method=mode, temperature=0.8,
                         top_k=40 if mode == "top_k" else 0))
    assert any(len(r["prompt"]) + r["max_new_tokens"] > 128 for r in reqs)
    return reqs


def _fault_free(st, what):
    """A run that met no fault. The server recovers from a failed block
    or admission by replaying its requests, so a failure that clears on
    retry shows only in its counters: no error, replay, restart or
    dropped block, and each token fetch a delivered block or an
    admission. `st` is a status read after the shutdown, or a run."""
    bad = {k: st[k] for k in ("errors", "replays", "restarts",
                              "blocks_dropped") if st[k]}
    if bad or st["token_fetches"] != st["steps"] + st["admissions"]:
        raise AssertionError(f"{what}: the server met a fault: {bad}; "
                             f"{st['token_fetches']} token fetches for "
                             f"{st['steps']} blocks and {st['admissions']} "
                             f"admissions")


def _serve(cfg, params, attn_impl, reqs):
    srv = GenerationServer(BertDecoder(cfg, params, attn_impl=attn_impl),
                           **SERVER)
    try:
        srv.warmup()
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        handles = [srv.submit(**r) for r in reqs]
        streams = [h.result(timeout=600) for h in handles]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        srv.shutdown()
    # after the shutdown, which delivers the block still in flight
    st = srv.status()
    _fault_free(st, f"serving ({attn_impl} attention)")
    return streams, handles, wall, _counts(), st


def phase_serving(cfg, params):
    reqs = _requests(cfg)
    streams, handles, wall, launches, st = _serve(cfg, params, "auto", reqs)
    ntok = sum(len(s) for s in streams)
    for r, s, h in zip(reqs, streams, handles):
        if len(s) != r["max_new_tokens"] or h.finish_reason != "length":
            raise AssertionError(f"serving: a request ended with "
                                 f"{len(s)} tokens ({h.finish_reason}), "
                                 f"expected {r['max_new_tokens']}")
        if any(not 0 <= tok < cfg.vocab_size for tok in s):
            raise AssertionError("serving: token id out of the vocab")
    if st["rung"] != 512:
        raise AssertionError(f"serving: no growth to rung 512 ({st})")
    missing = [k for k in ("flash_fwd", "flash_decode") if launches[k] == 0]
    if missing:
        raise AssertionError(f"serving: kernels never launched: {missing}")
    log(f"[serving] bert_base f32 slots=8 superstep=4: {len(reqs)} requests,"
        f" {ntok} tokens in {wall:.3f} s = {ntok / wall:.1f} tokens/s; "
        f"per-token p50 {st['per_token_p50_ms']:.3f} ms p99 "
        f"{st['per_token_p99_ms']:.3f} ms; {st['steps']} blocks, "
        f"{st['admissions']} admissions, rung {st['rung']}; launches "
        f"{launches}")
    dstreams, _, dwall, _, dst = _serve(cfg, params, "dense", reqs)
    greedy = [i for i, r in enumerate(reqs) if r["method"] == "greedy"]
    diff = [i for i in greedy if streams[i] != dstreams[i]]
    same_sampled = sum(streams[i] == dstreams[i] for i in range(len(reqs))
                       if i not in greedy)
    log(f"[serving] dense-attention server: {ntok / dwall:.1f} tokens/s; "
        f"greedy streams identical {len(greedy) - len(diff)}/{len(greedy)},"
        f" sampled identical {same_sampled}/{len(reqs) - len(greedy)}")
    if diff:
        raise AssertionError(f"serving: greedy streams {diff} differ from "
                             f"the dense-attention server")
    return {"requests": len(reqs), "tokens": ntok, "wall_s": wall,
            "tokens_per_s": ntok / wall,
            "per_token_p50_ms": st["per_token_p50_ms"],
            "per_token_p99_ms": st["per_token_p99_ms"],
            "blocks": st["steps"], "admissions": st["admissions"],
            "launches": launches, "dense_tokens_per_s": ntok / dwall,
            "dense_per_token_p50_ms": dst["per_token_p50_ms"],
            "sampled_identical": same_sampled}


# -- phase 6 ------------------------------------------------------------------
#: the fine-tune step of bench.py::_bench_bert_finetune: bert_base, f32,
#: batch 32 x 128 with ragged padding (lengths 64-128), random labels,
#: dropout 0.1, Adam(2e-5)
TRAIN = dict(batch=32, seq=128, lr=2e-5, warmup=2, steps=10)
#: flash vs dense gradients of one step, per leaf: max |flash - dense| <=
#: GRAD_RTOL * max |dense| (f32 sums in another order through 12 layers)
GRAD_RTOL = 1e-4


def _train_lengths(b, t):
    return np.random.default_rng(3).integers(t // 2, t + 1, b).tolist()


def _train_batch(cfg):
    rng = np.random.default_rng(4)
    b, t = TRAIN["batch"], TRAIN["seq"]
    dev = torch.device(DEV)
    return {"input_ids": torch.as_tensor(
                rng.integers(0, cfg.vocab_size, (b, t)), device=dev),
            "labels": torch.as_tensor(
                rng.integers(0, cfg.num_labels, b), device=dev),
            "attention_mask": _ragged_mask(_train_lengths(b, t), t,
                                           dev).float()}


def _trainable(tree):
    """A copy of the parameter tree whose leaves require grad."""
    if isinstance(tree, dict):
        return {k: _trainable(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_trainable(v) for v in tree]
    return tree.detach().clone().requires_grad_()


def _trainer(cfg, params, batch, generator, attn_impl="auto"):
    """One fine-tune step as bench.py builds it: loss, backward, Adam."""
    params = _trainable(params)
    opt = torch.optim.Adam(param_leaves(params), lr=TRAIN["lr"],
                           betas=(0.9, 0.999), eps=1e-8)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = classification_loss(cfg, params, batch, train=True,
                                   generator=generator, attn_impl=attn_impl)
        loss.backward()
        opt.step()
        return loss.detach()

    return step


def phase_train(cfg, params):
    batch = _train_batch(cfg)
    b, t, steps = TRAIN["batch"], TRAIN["seq"], TRAIN["steps"]
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    step = _trainer(cfg, params, batch, gen)
    losses = [step() for _ in range(TRAIN["warmup"])]
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    losses += [step() for _ in range(steps)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    losses = [float(x) for x in losses]
    per_step = {k: launches[k] / steps
                for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    log(f"[train] bert_base f32 B={b} T={t} dropout {cfg.dropout} "
        f"Adam({TRAIN['lr']}): {wall * 1e3 / steps:.2f} ms/step, "
        f"{steps / wall:.3f} steps/s, {b * t * steps / wall:.1f} tokens/s; "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; launches per step "
        f"{per_step}")
    wrong = {k: n for k, n in per_step.items() if n != cfg.num_layers}
    if wrong:
        raise AssertionError(f"train: launches per step {wrong}, expected "
                             f"{cfg.num_layers} of each")
    if not np.isfinite(losses).all():
        raise AssertionError(f"train: a loss is not finite: {losses}")
    del step

    # one step's gradients, dropout off: the kernels against dense attention
    grads = {}
    for impl in ("flash", "dense"):
        tree = _trainable(params)
        classification_loss(cfg, tree, batch, train=True,
                            attn_impl=impl).backward()
        grads[impl] = [(name, leaf.grad)
                       for name, leaf in named_param_leaves(tree)]
        del tree
    worst, bad = 0.0, []
    for (name, a), (_, d) in zip(grads["flash"], grads["dense"]):
        if a is None or d is None:
            if (a is None) != (d is None):
                bad.append(name)
            continue
        rel = ((a - d).abs().max() / d.abs().max().clamp_min(1e-30)).item()
        worst = max(worst, rel)
        if not rel <= GRAD_RTOL:
            bad.append(f"{name} ({rel:.2e})")
    del grads
    log(f"[train] one step, dropout off: flash vs dense gradients, worst "
        f"leaf max|diff|/max|dense| = {worst:.3e} (rtol {GRAD_RTOL:.0e})")
    if bad:
        raise AssertionError(f"train: flash gradients differ from dense: "
                             f"{bad}")

    # ten steps on one fixed batch, dropout off: the loss must fall
    step = _trainer(cfg, params, batch, None)
    fixed = [float(step()) for _ in range(10)]
    del step
    log(f"[train] 10 steps on one batch, dropout off: loss "
        f"{fixed[0]:.4f} -> {fixed[-1]:.4f}")
    if not (np.isfinite(fixed).all() and fixed[-1] < fixed[0]):
        raise AssertionError(f"train: loss did not fall: {fixed}")
    return {"ms_per_step": wall * 1e3 / steps, "steps_per_s": steps / wall,
            "tokens_per_s": b * t * steps / wall, "losses": losses,
            "launches": launches, "launches_per_step": per_step,
            "grad_worst_rel": worst, "fixed_batch_losses": fixed}


# -- phase 7 ------------------------------------------------------------------
#: the ResNet serving workload: at least 96 images of 224×224×3 as
#: requests of 1-8 rows from 8 client threads, coalesced up to 32 rows
RESNET = dict(batch=32, images=96, threads=8, seed=0, timed=5)
#: fused vs unfused on the card, answers and features: f32 sums in
#: another order through 53 layers, held to RESNET_RTOL of the largest
#: unfused value
RESNET_RTOL = 1e-4
#: conv1x1+BN pairs the fusion marks in ResNet-50: the _a and _c convs of
#: 16 blocks and 4 shortcuts
EPILOGUE_PAIRS = 36


def _perturb_bn(net, seed):
    """Draw every BN's running statistics and γ/β from a seeded generator,
    so the fold is not the identity. The last BN of each residual branch
    (_c, _sc) gets γ in [0.2, 0.5], which keeps the activations O(1)
    through the 16 blocks (at γ ~ 1 they grow to tens by res5 and the
    softmax saturates)."""
    rng = np.random.default_rng(seed)
    for name in sorted(net._state):
        st, p = net._state[name], net._params[name]
        n = st["mean"].shape[0]
        lo, hi = (0.2, 0.5) if name.endswith(("_c_bn", "_sc_bn")) \
            else (0.5, 1.0)
        for t, v in ((st["mean"], rng.normal(0, 0.1, n)),
                     (st["var"], rng.uniform(0.5, 1.5, n)),
                     (p["gamma"], rng.uniform(lo, hi, n)),
                     (p["beta"], rng.normal(0, 0.1, n))):
            t.copy_(torch.as_tensor(v, dtype=torch.float32))


def _resnet_nets(**zoo):
    """(fused, unfused) ResNet-50 at 224×224×3, 1000 classes, f32, both
    from the zoo's seed with the same BN draws; `zoo` goes to ResNet50."""
    before = os.environ.get("DL4J_TPU_FUSE_CONV_BN")
    nets = []
    try:
        for fuse in ("1", "0"):
            os.environ["DL4J_TPU_FUSE_CONV_BN"] = fuse
            net = ResNet50(**zoo).init(DEV)
            _perturb_bn(net, RESNET["seed"])
            nets.append(net)
    finally:
        if before is None:
            os.environ.pop("DL4J_TPU_FUSE_CONV_BN", None)
        else:
            os.environ["DL4J_TPU_FUSE_CONV_BN"] = before
    fused, plain = nets
    if len(fused._fused_pairs) != EPILOGUE_PAIRS or plain._fused_pairs:
        raise AssertionError(f"resnet: {len(fused._fused_pairs)} fused pairs"
                             f" (expected {EPILOGUE_PAIRS}), "
                             f"{len(plain._fused_pairs)} in the unfused net")
    return fused, plain


def _serve_resnet(net, images, sizes, ladder=None, cache_dir=None):
    """The requests through ParallelInference(BATCHED, batchLimit=32) from
    RESNET["threads"] client threads; with `ladder`, through its bucket
    graphs (`bucketLadder(ladder)`, `warmup()`). Returns (answers,
    per-request latencies s, wall s, kernel launches, forwards, {warmup
    stats, status})."""
    off = np.concatenate([[0], np.cumsum(sizes)])
    answers, lat, errs = [None] * len(sizes), [None] * len(sizes), []
    nxt, lock = [0], threading.Lock()
    builder = (ParallelInference.Builder(net)
               .inferenceMode(InferenceMode.BATCHED)
               .batchLimit(RESNET["batch"]))
    if ladder is not None:
        builder.bucketLadder(ladder).executableCacheDir(cache_dir)
    pi = builder.build()

    def client():
        while True:
            with lock:
                i = nxt[0]
                nxt[0] += 1
            if i >= len(sizes):
                return
            t = time.perf_counter()
            try:
                answers[i] = pi.output(images[off[i]:off[i + 1]])
            except Exception as e:  # noqa: BLE001 — re-raised below
                errs.append(e)
                return
            lat[i] = time.perf_counter() - t

    info = {}
    try:
        if ladder is not None:
            info["warmup"] = pi.warmup()
        else:
            # warm: the allocator grows to the padded batch sizes the
            # collector forms (32 rows, and 64 when a batch runs past 32)
            for rows in (1, RESNET["batch"], 2 * RESNET["batch"]):
                pi.output(np.resize(images, (rows,) + images.shape[1:]))
        torch.cuda.synchronize()
        _reset_counts()
        calls = pi.model_calls
        threads = [threading.Thread(target=client)
                   for _ in range(RESNET["threads"])]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counts()
        calls = pi.model_calls - calls
        info["status"] = pi.status()
    finally:
        pi.shutdown()
    if errs or any(t.is_alive() for t in threads):
        raise AssertionError(f"resnet: serving failed: {errs}")
    return answers, lat, wall, launches, calls, info


def _forward_ms(net, x):
    """Mean host-clock ms of one forward ending in a synchronize, after two
    warm-up forwards."""
    for _ in range(2):
        net.output(x)
    torch.cuda.synchronize()
    times = []
    for _ in range(RESNET["timed"]):
        t = time.perf_counter()
        net.output(x)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.mean(times)), float(np.min(times))


def _fold(net, bn):
    """The (scale, shift) of a BN node's inference affine."""
    st, p = net._state[bn], net._params[bn]
    inv = torch.rsqrt(st["var"] + net.getLayer(bn).eps)
    return p["gamma"] * inv, p["beta"] - p["gamma"] * st["mean"] * inv


def _res4_block_check(net, acts):
    """bottleneck_block on res4_1's three convs with their BNs folded in,
    from the fused net's res4_0_relu activation, against its
    res4_1_relu."""
    (a1, c1), (a2, c2), (a3, c3) = (_fold(net, f"res4_1_{k}_bn")
                                    for k in "abc")
    w = {k: net._params[f"res4_1_{k}_conv"]["W"] for k in "abc"}
    before = bottleneck_block.launches
    y = bottleneck_block(acts["res4_0_relu"], w["a"][0, 0] * a1, c1,
                         w["b"] * a2, c2, w["c"][0, 0] * a3, c3,
                         block_b=RESNET["batch"] // 4)
    want = acts["res4_1_relu"]
    torch.cuda.synchronize()
    err = (y - want).abs().max().item()
    tol = RESNET_RTOL * want.abs().max().item()
    return {"max_abs_err": err, "tol": tol,
            "launches": bottleneck_block.launches - before,
            "shape": list(y.shape)}


def _resnet_requests():
    """(request sizes of 1-8 rows, summing to >= RESNET["images"], the
    images), from a seed."""
    rng = np.random.default_rng(5)
    sizes = []
    while sum(sizes) < RESNET["images"]:
        sizes.append(int(rng.integers(1, 9)))
    images = rng.standard_normal((sum(sizes), 224, 224, 3)).astype(
        np.float32)
    return sizes, images


def phase_resnet():
    fused, plain = _resnet_nets()
    sizes, images = _resnet_requests()
    answers, lat, wall, launches, calls, _ = _serve_resnet(fused, images,
                                                           sizes)
    n_img = int(sum(sizes))
    # the unfused net's answers for the same rows, on the card
    want = np.concatenate([plain.output(images[i:i + RESNET["batch"]])
                           .cpu().numpy()
                           for i in range(0, n_img, RESNET["batch"])])
    got = np.concatenate(answers)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    lat_ms = np.asarray(lat) * 1e3
    per_forward = launches["matmul_epilogue"] / max(calls, 1)
    log(f"[resnet] ResNet-50 224x224x3 f32, fusion on: {n_img} images in "
        f"{len(sizes)} requests of 1-8 rows from {RESNET['threads']} "
        f"threads, {calls} coalesced forwards, {wall:.3f} s = "
        f"{n_img / wall:.1f} images/s; per-request p50 "
        f"{np.percentile(lat_ms, 50):.2f} ms p99 "
        f"{np.percentile(lat_ms, 99):.2f} ms; matmul_epilogue launches "
        f"{launches['matmul_epilogue']} ({per_forward:.1f} per forward); "
        f"max |fused - unfused| = {err:.3e} of max {scale:.3e} "
        f"(rtol {RESNET_RTOL:.0e})")
    if launches["matmul_epilogue"] != EPILOGUE_PAIRS * calls or calls == 0:
        raise AssertionError(f"resnet: {launches['matmul_epilogue']} "
                             f"matmul_epilogue launches over {calls} "
                             f"forwards, expected {EPILOGUE_PAIRS} each")
    if got.shape != (n_img, 1000) or not np.isfinite(got).all():
        raise AssertionError(f"resnet: bad answers {got.shape}")
    if not err <= RESNET_RTOL * scale:
        raise AssertionError(f"resnet: fused answers differ from the "
                             f"unfused net's by {err}")
    x = torch.as_tensor(images[:RESNET["batch"]], device=DEV)
    fa = fused.feedForward(x)
    fb = plain.feedForward(x)
    feat_err = (fa["avgpool"] - fb["avgpool"]).abs().max().item()
    feat_scale = fb["avgpool"].abs().max().item()
    del fb
    block = _res4_block_check(fused, fa)
    del fa
    log(f"[resnet] avgpool features B={RESNET['batch']}: max |fused - "
        f"unfused| = {feat_err:.3e} of max {feat_scale:.3e}; "
        f"bottleneck_block on res4_1 (folded BNs) from res4_0_relu "
        f"{block['shape']}: max |kernel - res4_1_relu| = "
        f"{block['max_abs_err']:.3e} (tol {block['tol']:.3e})")
    if not feat_err <= RESNET_RTOL * feat_scale:
        raise AssertionError(f"resnet: avgpool features differ by "
                             f"{feat_err}")
    if not block["max_abs_err"] <= block["tol"] or block["launches"] != 1:
        raise AssertionError(f"resnet: bottleneck_block does not give "
                             f"res4_1_relu: {block}")
    fused_ms, fused_min = _forward_ms(fused, x)
    plain_ms, plain_min = _forward_ms(plain, x)
    log(f"[resnet] one B={RESNET['batch']} forward: fused {fused_ms:.3f} ms "
        f"(min {fused_min:.3f}), unfused {plain_ms:.3f} ms (min "
        f"{plain_min:.3f}); {RESNET['batch'] / fused_ms * 1e3:.1f} vs "
        f"{RESNET['batch'] / plain_ms * 1e3:.1f} images/s")
    del plain
    pure = _forward_fn_check(fused, x)
    stats = {"images": n_img, "requests": len(sizes), "forwards": calls,
             "wall_s": wall, "images_per_s": n_img / wall,
             "p50_ms": float(np.percentile(lat_ms, 50)),
             "p99_ms": float(np.percentile(lat_ms, 99)),
             "launches": launches, "epilogue_per_forward": per_forward,
             "max_abs_err": err, "answer_scale": scale,
             "avgpool_err": feat_err, "avgpool_scale": feat_scale,
             "res4_block": block, "forward_ms": fused_ms,
             "forward_min_ms": fused_min, "unfused_forward_ms": plain_ms,
             "unfused_forward_min_ms": plain_min, "forward_fn": pure}
    return stats, fused, x


def _forward_fn_check(net, x):
    """`runtime.executables.forward_fn(net)` on the batch `x` against the
    net's own forward: bit for bit, with one forward's launches of the
    epilogue kernel (one per fused pair)."""
    fn = forward_fn(net)
    torch.cuda.synchronize()
    _reset_counts()
    (got,) = fn(net._params, net._state, x)
    torch.cuda.synchronize()
    launches = _counts()["matmul_epilogue"]
    with torch.no_grad():
        want = net._output(x)
    equal = torch.equal(got, want)
    log(f"[resnet] forward_fn(fused ResNet-50) B={x.shape[0]}: bit-identical "
        f"to output() {equal}; matmul_epilogue launches {launches}")
    if not equal or launches != EPILOGUE_PAIRS:
        raise AssertionError(f"resnet: forward_fn: bit-identical {equal}, "
                             f"{launches} epilogue launches (expected "
                             f"{EPILOGUE_PAIRS})")
    return {"bit_identical": equal, "matmul_epilogue": launches}


# -- phase 8 ------------------------------------------------------------------
#: ResNet-50 training: one seeded batch of 32 images and labels, 2 warm-up
#: and 10 timed steps, the zoo's Nesterovs at momentum 0.9 and a rate of
#: 0.01: at the zoo's 0.1 the loss on one fixed batch rises from this init
#: (10.7 -> 26.1 in 12 steps at 64×64, B=8, on the CPU, where 0.01 takes it
#: to 3.0)
RESNET_TRAIN = dict(batch=32, size=224, warmup=2, steps=10, seed=7, lr=0.01)
#: One step's gradients are held to the unfused net's run in f64. At this
#: random init they are ill-conditioned in f32: a relu input within f32
#: noise of 0 takes the other branch, BN's backward spreads that over its
#: channel, and both f32 nets land ~2 % (median leaf, max |err| over max
#: |f64|) from the f64 answer, each leaf by its own luck; fused and unfused
#: f32 differ from each other by as much (up to 14 % of a leaf's largest
#: on the card). So the fusion may add no error beyond f32's own: each
#: fused leaf within max(RESNET_GRAD_RTOL, RESNET_GRAD_FACTOR × its unfused
#: distance, the unfused net's worst leaf), and the fused median within
#: RESNET_GRAD_FACTOR × the unfused median. A wrong term in the fused
#: backward moves every leaf it reaches by O(1).
RESNET_GRAD_RTOL = 1e-3
RESNET_GRAD_FACTOR = 2.0
#: the kernels of the training fusion, launched once per pair and step
TRAIN_KERNELS = ("matmul_stats", "bn_grad_stats", "bn_conv_grads")


def _train_batch_resnet():
    rng = np.random.default_rng(RESNET_TRAIN["seed"])
    b = RESNET_TRAIN["batch"]
    hw = RESNET_TRAIN["size"]
    x = rng.standard_normal((b, hw, hw, 3)).astype(np.float32)
    y = np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, b)]
    return DataSet(x, y)


def _leaf_errors(got, want):
    """{(node, key): max |got − want| / max |want|} over two {node: {key:
    tensor}} trees, in f64."""
    out = {}
    for n in sorted(want):
        for k in sorted(want[n]):
            a, w = got[n][k].double(), want[n][k].double()
            out[n, k] = ((a - w).abs().max()
                         / w.abs().max().clamp_min(1e-300)).item()
    return out


def _in_f64(net):
    """A copy of `net` whose forward and backward run in f64."""
    m = net.clone()
    m._compute_dtype = torch.float64
    m._params = {n: {k: v.double() for k, v in d.items()}
                 for n, d in m._params.items()}
    m._state = {n: {k: v.double() for k, v in d.items()}
                for n, d in m._state.items()}
    return m


def phase_resnet_train():
    """ResNet-50 trained with the fusion on; returns (stats, the fused net,
    the batch) for the profile phase."""
    fused, plain = _resnet_nets(updater=Nesterovs(RESNET_TRAIN["lr"], 0.9))
    ds = _train_batch_resnet()
    ins, labels, _ = fused._unpack(ds)
    # one step's gradients and BN statistics: fused, unfused, unfused in f64
    lf, gf, sf = fused._value_and_grad(ins, labels)
    lp, gp, sp = plain._value_and_grad(ins, labels)
    exact = _in_f64(plain)
    del plain
    le, ge, _ = exact._value_and_grad(ins, labels)
    del exact
    ef, eu, direct = (_leaf_errors(gf, ge), _leaf_errors(gp, ge),
                      _leaf_errors(gf, gp))
    state = _leaf_errors(sf, sp)
    del gf, gp, ge, sf, sp
    eu_worst, eu_median = max(eu.values()), float(np.median(list(
        eu.values())))
    bad = [f"{n}/{k} ({ef[n, k]:.2e} vs unfused {eu[n, k]:.2e})"
           for n, k in ef if not ef[n, k] <= max(
               RESNET_GRAD_RTOL, RESNET_GRAD_FACTOR * eu[n, k], eu_worst)]
    if not np.median(list(ef.values())) <= RESNET_GRAD_FACTOR * eu_median:
        bad.append(f"median {np.median(list(ef.values())):.2e} vs unfused "
                   f"{eu_median:.2e}")
    s_bad = [f"{n}/{k}" for (n, k), e in state.items() if not e <= RESNET_RTOL]
    ratio = max(ef[key] / max(eu[key], RESNET_GRAD_RTOL) for key in ef)
    log(f"[resnet_train] one step B={RESNET_TRAIN['batch']}: loss fused "
        f"{lf.item():.6f} unfused {lp.item():.6f} f64 {le.item():.6f}; "
        f"gradients against the unfused net in f64, per leaf max|err|/"
        f"max|f64|: fused worst {max(ef.values()):.3e} median "
        f"{np.median(list(ef.values())):.3e}, unfused f32 worst "
        f"{max(eu.values()):.3e} median {np.median(list(eu.values())):.3e};"
        f" worst per-leaf fused/unfused ratio {ratio:.3f}; fused vs "
        f"unfused directly worst {max(direct.values()):.3e} median "
        f"{np.median(list(direct.values())):.3e}; BN running statistics, "
        f"worst {max(state.values()):.3e} (rtol {RESNET_RTOL:.0e})")
    if bad or s_bad or not torch.isfinite(lf):
        raise AssertionError(f"resnet_train: the fused gradients or BN "
                             f"state are off: gradients {bad}, BN state "
                             f"{s_bad}")
    # the timed steps, through fit, as a user trains
    losses = []
    for _ in range(RESNET_TRAIN["warmup"]):
        fused.fit(ds)
        losses.append(fused._score)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    for _ in range(RESNET_TRAIN["steps"]):
        fused.fit(ds)
        losses.append(fused._score)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    steps, b = RESNET_TRAIN["steps"], RESNET_TRAIN["batch"]
    losses = [float(v) for v in losses]
    per_step = {k: launches[k] / steps for k in TRAIN_KERNELS}
    upd = fused.getLayer("fc").updater
    hw = RESNET_TRAIN["size"]
    log(f"[resnet_train] ResNet-50 {hw}x{hw}x3 f32 B={b}, fusion on, "
        f"{type(upd).__name__}({upd.learningRate}, {upd.momentum}) (the "
        f"zoo's rate is 0.1): "
        f"{wall * 1e3 / steps:.2f} ms/step, {b * steps / wall:.1f} images/s; "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f} over "
        f"{len(losses)} steps on one batch; launches per step {per_step}")
    wrong = {k: n for k, n in per_step.items() if n != EPILOGUE_PAIRS}
    if wrong:
        raise AssertionError(f"resnet_train: launches per step {wrong}, "
                             f"expected {EPILOGUE_PAIRS} of each")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"resnet_train: loss did not fall: {losses}")
    return ({"ms_per_step": wall * 1e3 / steps, "images_per_s": b * steps
             / wall, "losses": losses, "launches": launches,
             "launches_per_step": per_step,
             "grad_fused_vs_f64_worst": max(ef.values()),
             "grad_unfused_vs_f64_worst": max(eu.values()),
             "grad_fused_unfused_ratio_worst": ratio,
             "grad_fused_vs_unfused_worst": max(direct.values()),
             "state_worst_rel": max(state.values()),
             "loss_fused": lf.item(), "loss_unfused": lp.item(),
             "loss_f64": le.item()}, fused, ds)


# -- phase 9: graphs ----------------------------------------------------------
#: the executable store's three capture targets, each against its eager
#: run in turns on this card (eager, graph, graph, eager): BERT serving
#: (the serving phase's 12 requests), ResNet-50 training at B=32 (2 warm-up
#: and GRAPHS["steps"] timed `fit` steps per arm; bit identity over
#: GRAPHS["check_steps"] steps, with cuDNN's deterministic algorithms on:
#: its default weight-gradient convolutions sum in a varying order, so two
#: eager steps already differ in the last bits), and ResNet-50 served
#: through `ParallelInference` with the bucket ladder
GRAPHS = dict(steps=10, check_steps=3, buckets=[1, 2, 4, 8, 16, 32],
              forwards=10)
ARMS = ("eager", "graph", "graph", "eager")
#: the fit A/B: (arm, prefetch depth) in mirrored turns, so that the
#: graph's gain and the prefetch's gain are measured apart (prefetch 0
#: copies each batch from pageable memory when its step starts)
FIT_ARMS = (("eager", 0), ("graph", 0), ("graph", 2), ("eager", 2),
            ("eager", 2), ("graph", 2), ("graph", 0), ("eager", 0))


def _store_clean(st, what):
    """A graph store that served without capturing, degrading or running
    eagerly after its warmup; logs its counts."""
    counts = {k: st[k] for k in ("keys", "captures", "replays",
                                 "live_captures", "eager_calls",
                                 "degradations")}
    log(f"[graphs] {what} store: {counts}")
    bad = {k: st[k] for k in ("live_captures", "degradations",
                              "eager_calls") if st[k]}
    if bad or st["replays"] == 0 or not st["capture"]:
        raise AssertionError(f"graphs: {what}: {bad or st}")


def _graphs_serving(cfg, params, cache_dir):
    reqs = _requests(cfg)
    runs = []
    for arm in ARMS:
        graph = arm == "graph"
        srv = GenerationServer(BertDecoder(cfg, params), cuda_graphs=graph,
                               exec_cache_dir=cache_dir if graph else None,
                               **SERVER)
        try:
            warm = srv.warmup()
            torch.cuda.synchronize()
            _reset_counts()
            t0 = time.perf_counter()
            streams = [h.result(timeout=600)
                       for h in [srv.submit(**r) for r in reqs]]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            srv.shutdown()
        # after the shutdown, which delivers the block still in flight
        launches = _counts()
        st = srv.status()
        _fault_free(st, f"graphs: serving {arm}")
        ntok = sum(len(x) for x in streams)
        ex = st["executables"]
        run = {"arm": arm, "wall_s": wall, "tokens": ntok,
               "tokens_per_s": ntok / wall, "blocks": st["steps"],
               "admissions": st["admissions"],
               "per_token_p50_ms": st["per_token_p50_ms"],
               "per_token_p99_ms": st["per_token_p99_ms"],
               "launches": {k: launches[k]
                            for k in ("flash_fwd", "flash_decode")},
               "warmup": warm, "replays": ex["replays"],
               "eager_calls": ex["eager_calls"]}
        log(f"[graphs] serving {arm}: {ntok} tokens in {wall:.3f} s = "
            f"{ntok / wall:.1f} tokens/s; per-token p50 "
            f"{st['per_token_p50_ms']:.3f} ms p99 "
            f"{st['per_token_p99_ms']:.3f} ms; {st['steps']} blocks, "
            f"{st['admissions']} admissions; host calls: "
            f"{ex['replays']} graph replays, {ex['eager_calls']} eager "
            f"calls; launches {run['launches']}; warmup {warm}")
        want = (cfg.num_layers * st["admissions"],
                cfg.num_layers * SERVER["superstep"] * st["steps"])
        if (launches["flash_fwd"], launches["flash_decode"]) != want:
            raise AssertionError(f"graphs: serving {arm} launched "
                                 f"{run['launches']}, expected {want}")
        if graph:
            _store_clean(ex, "serving")
        if runs and streams != runs[0]["streams"]:
            diff = [i for i, (a, b) in enumerate(zip(streams,
                                                     runs[0]["streams"]))
                    if a != b]
            raise AssertionError(f"graphs: serving {arm} streams {diff} "
                                 f"differ from the eager server's")
        runs.append(dict(run, streams=streams))
    first, second = runs[1]["warmup"], runs[2]["warmup"]
    keys = first["executables"]
    log(f"[graphs] serving store: {keys} keys; first warmup compiled "
        f"{first['compiled']} from_disk {first['from_disk']}; second "
        f"(same directory) compiled {second['compiled']} from_disk "
        f"{second['from_disk']} nvcc runs {second['nvcc_runs']}, "
        f"{second['seconds']:.2f} s; every stream equal to the eager "
        f"server's (greedy and sampled)")
    if (first["compiled"], first["from_disk"]) != (keys, 0) or (
            second["compiled"], second["from_disk"],
            second["nvcc_runs"]) != (0, keys, 0):
        raise AssertionError(f"graphs: the serving store's disk tier: "
                             f"{first} then {second}")
    for r in runs:
        del r["streams"]
    return runs


def _graphs_fit():
    fused, plain = _resnet_nets(updater=Nesterovs(RESNET_TRAIN["lr"], 0.9))
    del plain
    ds = _train_batch_resnet()
    n, b = GRAPHS["check_steps"], RESNET_TRAIN["batch"]
    # two eager steps from one state, cuDNN's default algorithms
    one, two = fused.clone(), fused.clone()
    one.fit(ds, cudaGraphs=False)
    two.fit(ds, cudaGraphs=False)
    pairs = list(zip(tensor_leaves(one._params), tensor_leaves(two._params)))
    eager_unequal = sum(not torch.equal(x, y) for x, y in pairs)
    eager_diff = max((x - y).abs().max().item() for x, y in pairs)
    log(f"[graphs] fit: two eager steps from one state, default cuDNN: "
        f"{eager_unequal} of {len(pairs)} parameter tensors differ, by at "
        f"most {eager_diff:.3e}")
    del one, two, pairs
    torch.backends.cudnn.deterministic = True
    try:
        graph, eager = fused.clone(), fused.clone()
        graph.fit(ListDataSetIterator([ds] * n, b))
        eager.fit([ds] * n, prefetch=0, cudaGraphs=False)
        torch.cuda.synchronize()
        unequal = {what: sum(not torch.equal(x, y) for x, y in zip(
            tensor_leaves(getattr(graph, attr)),
            tensor_leaves(getattr(eager, attr))))
            for what, attr in (("parameters", "_params"),
                               ("optimizer state", "_opt_state"),
                               ("BN state", "_state"))}
        scores = (graph.score(), eager.score())
        st = graph.fit_status()
    finally:
        torch.backends.cudnn.deterministic = False
    log(f"[graphs] fit ResNet-50 B={b}, {n} steps, cuDNN deterministic: "
        f"graph vs eager tensors not bit-identical {unequal}; loss "
        f"{scores[0]!r} vs {scores[1]!r}; graph store: {st['captures']} "
        f"capture, {st['replays']} replays, {st['degradations']} "
        f"degradations")
    if any(unequal.values()) or scores[0] != scores[1] or (
            st["captures"], st["replays"], st["degradations"]) != (
                1, n - 1, 0):
        raise AssertionError(f"graphs: the fit step's replays differ from "
                             f"the eager steps: {unequal}, {scores}, {st}")
    del graph, eager
    nets = {"eager": fused.clone(), "graph": fused.clone()}
    del fused
    for arm, net in nets.items():
        net.fit(ListDataSetIterator([ds] * RESNET_TRAIN["warmup"], b),
                cudaGraphs=arm == "graph")
    torch.cuda.synchronize()
    runs = []
    steps = GRAPHS["steps"]
    for arm, prefetch in FIT_ARMS:
        net = nets[arm]
        _reset_counts()
        # an iterator that opts in to the prefetch (a plain list does not)
        it = ListDataSetIterator([ds] * steps, b)
        t0 = time.perf_counter()
        net.fit(it, prefetch=prefetch, cudaGraphs=arm == "graph")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counts()
        per_step = {k: launches[k] / steps for k in TRAIN_KERNELS}
        loss = net.score()
        st = net.fit_status()
        runs.append({"arm": arm, "prefetch": prefetch,
                     "ms_per_step": wall * 1e3 / steps,
                     "images_per_s": b * steps / wall, "loss": loss,
                     "launches_per_step": per_step,
                     "replays": None if st is None else st["replays"]})
        log(f"[graphs] fit {arm} (prefetch {prefetch}): "
            f"{wall * 1e3 / steps:.2f} ms/step, {b * steps / wall:.1f} "
            f"images/s, loss {loss:.4f}; launches per step {per_step}")
        if any(v != EPILOGUE_PAIRS for v in per_step.values()) or \
                not np.isfinite(loss):
            raise AssertionError(f"graphs: fit {arm}: {runs[-1]}")
    st = nets["graph"].fit_status()
    if st["captures"] != 1:
        raise AssertionError(f"graphs: the fit step was captured again: "
                             f"{st}")
    _store_clean(st, "fit")
    return {"bit_identity": {"steps": n, "unequal": unequal,
                             "scores": scores,
                             "eager_default_cudnn_unequal": eager_unequal,
                             "eager_default_cudnn_max_diff": eager_diff},
            "runs": runs, "store": {k: st[k] for k in (
                "captures", "replays", "degradations", "eager_calls")}}


def _graphs_inference(cache_dir):
    fused, plain = _resnet_nets()
    del plain
    sizes, images = _resnet_requests()
    n_img = int(sum(sizes))
    want = np.concatenate([fused.output(images[i:i + RESNET["batch"]])
                           .cpu().numpy()
                           for i in range(0, n_img, RESNET["batch"])])
    scale = float(np.abs(want).max())
    # each bucket's replay against the eager forward at the same rows
    store = ExecutableStore(fused)
    buckets = GRAPHS["buckets"]
    feat = images.shape[1:]
    store.warmup([(((bk, *feat), "float32"),) for bk in buckets])
    unequal = []
    for bk in buckets:
        sig = (((bk, *feat), "float32"),)
        x = images[:bk]
        (static,) = store.ensure(sig)
        static.copy_(torch.as_tensor(x, device=DEV))
        got = store.run(("forward", sig))
        if not torch.equal(got, fused.output(x)):
            unequal.append(bk)
    log(f"[graphs] inference buckets {buckets}: replay vs eager forward "
        f"on the same rows, not bit-identical: {unequal or 'none'}")
    if unequal:
        raise AssertionError(f"graphs: buckets {unequal} differ from the "
                             f"eager forward")
    # one B=32 forward, eager against its graph, in turns
    x = torch.as_tensor(images[:RESNET["batch"]], device=DEV)
    sig = (((RESNET["batch"], *feat), "float32"),)
    (static,) = store.ensure(sig)

    def replay():
        static.copy_(x)
        return store.run(("forward", sig))

    forward = []
    for arm in ARMS:
        fn = replay if arm == "graph" else (lambda: fused.output(x))
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(GRAPHS["forwards"]):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        forward.append({"arm": arm, "ms": float(np.mean(times)),
                        "min_ms": float(np.min(times))})
    log("[graphs] one B=32 forward (host clock, mean / min of "
        f"{GRAPHS['forwards']}): " + ", ".join(
            f"{r['arm']} {r['ms']:.3f} / {r['min_ms']:.3f} ms"
            for r in forward))
    del store
    # the 96 images through ParallelInference, eager against the ladder
    runs = []
    for arm in ARMS:
        graph = arm == "graph"
        answers, lat, wall, launches, calls, info = _serve_resnet(
            fused, images, sizes, ladder=buckets if graph else None,
            cache_dir=cache_dir)
        got = np.concatenate(answers)
        err = float(np.abs(got - want).max())
        lat_ms = np.asarray(lat) * 1e3
        st = info["status"]
        run = {"arm": arm, "wall_s": wall, "images_per_s": n_img / wall,
               "p50_ms": float(np.percentile(lat_ms, 50)),
               "p99_ms": float(np.percentile(lat_ms, 99)),
               "forwards": calls, "max_abs_err": err,
               "matmul_epilogue": launches["matmul_epilogue"],
               "warmup": info.get("warmup"),
               "aot_fallbacks": st["aot_fallbacks"]}
        log(f"[graphs] inference {arm}: {n_img} images, {calls} forwards, "
            f"{wall:.3f} s = {n_img / wall:.1f} images/s; p50 "
            f"{run['p50_ms']:.2f} ms p99 {run['p99_ms']:.2f} ms; "
            f"matmul_epilogue launches {launches['matmul_epilogue']}; "
            f"max |answer - net.output| = {err:.3e} of max {scale:.3e}"
            + (f"; warmup {info['warmup']}" if graph else ""))
        if got.shape != (n_img, 1000) or not err <= RESNET_RTOL * scale:
            raise AssertionError(f"graphs: inference {arm} answers differ "
                                 f"from net.output by {err}")
        if launches["matmul_epilogue"] != EPILOGUE_PAIRS * calls:
            raise AssertionError(f"graphs: inference {arm}: "
                                 f"{launches['matmul_epilogue']} epilogue "
                                 f"launches over {calls} forwards")
        if graph:
            _store_clean(st["executables"], "inference")
            if st["aot_fallbacks"]:
                raise AssertionError(f"graphs: inference fell back: "
                                     f"{st['aot_error']}")
        runs.append(run)
    first, second = runs[1]["warmup"], runs[2]["warmup"]
    # a store given no signature captures what the manifest records
    third = ExecutableStore(fused, directory=cache_dir).warmup([])
    torch.cuda.synchronize()
    log(f"[graphs] inference disk tier: first warmup {first}; second "
        f"(same directory) {second}; a store given no signature warms "
        f"the manifest's {third}")
    if (first["compiled"], first["from_disk"]) != (len(buckets), 0) or (
            second["compiled"], second["from_disk"],
            second["nvcc_runs"]) != (0, len(buckets), 0) or (
            third["keys"], third["from_disk"], third["compiled"],
            third["nvcc_runs"]) != (len(buckets), len(buckets), 0, 0):
        raise AssertionError(f"graphs: the inference store's disk tier: "
                             f"{first} then {second} then {third}")
    env = _graphs_env_cache(fused, images, sizes, want,
                            os.path.join(cache_dir, "env"))
    return {"buckets": buckets, "forward": forward, "runs": runs,
            "manifest_warmup": third, "env_cache": env}


def _files_under(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, names in os.walk(root) for f in names)


def _graphs_env_cache(fused, images, sizes, want, directory):
    """The stores' default directory on the card: with $DL4J_EXEC_CACHE at
    `directory`, two ParallelInference instances over the bucket ladder,
    built without executableCacheDir, each warmed and then serving every
    request in turn from one thread (so each request is one dispatch, the
    same in both). The second warms every key from the first's manifest
    and answers bit for bit as the first. Then two graphed `fit` steps of
    `fused` with the variable set leave the directory's files as they
    were. The variable is restored after."""
    buckets = GRAPHS["buckets"]
    off = np.concatenate([[0], np.cumsum(sizes)])
    before = os.environ.get(ENV_CACHE_DIR)
    os.environ[ENV_CACHE_DIR] = directory
    try:
        runs = []
        for _ in range(2):
            pi = (ParallelInference.Builder(fused)
                  .inferenceMode(InferenceMode.BATCHED)
                  .batchLimit(RESNET["batch"]).bucketLadder(buckets).build())
            try:
                warm = pi.warmup()
                got = np.concatenate([pi.output(images[off[i]:off[i + 1]])
                                      for i in range(len(sizes))])
                st = pi.status()
            finally:
                pi.shutdown()
            runs.append((warm, got, st))
        files = _files_under(directory)
        ds = _train_batch_resnet()
        fused.fit(ListDataSetIterator([ds] * 2, RESNET_TRAIN["batch"]))
        torch.cuda.synchronize()
        after = _files_under(directory)
        fit_st = fused.fit_status()     # None where fit ran no graphs
        fit_dir = None if fit_st is None else fit_st["directory"]
    finally:
        if before is None:
            os.environ.pop(ENV_CACHE_DIR, None)
        else:
            os.environ[ENV_CACHE_DIR] = before
    (w1, a1, s1), (w2, a2, s2) = runs
    scale = float(np.abs(want).max())
    err = float(np.abs(a1 - want).max())
    same = bool(np.array_equal(a1, a2))
    log(f"[graphs] ${ENV_CACHE_DIR} ladder {buckets}, no "
        f"executableCacheDir: first warmup {w1}; second {w2}; answers "
        f"bit-identical {same}, max |answer - output()| {err:.3e} of max "
        f"{scale:.3e}; store directory {s2['executables']['directory']}; "
        f"files {files}; after a graphed fit {after} (fit store directory "
        f"{fit_dir})")
    if (w1["compiled"], w1["from_disk"]) != (len(buckets), 0) or (
            w2["compiled"], w2["from_disk"], w2["keys"]) != (
            0, len(buckets), len(buckets)):
        raise AssertionError(f"graphs: ${ENV_CACHE_DIR} warmups {w1} then "
                             f"{w2}")
    if not same or a1.shape != want.shape or not err <= RESNET_RTOL * scale:
        raise AssertionError(f"graphs: ${ENV_CACHE_DIR} answers: "
                             f"bit-identical {same}, error {err}")
    if s1["executables"]["directory"] != directory or not files:
        raise AssertionError(f"graphs: the stores ignored "
                             f"${ENV_CACHE_DIR}: {s1['executables']}, "
                             f"{files}")
    if after != files or fit_dir is not None:
        raise AssertionError(f"graphs: fit wrote under ${ENV_CACHE_DIR}: "
                             f"{files} -> {after}, {fit_dir}")
    return {"warmups": [w1, w2], "bit_identical": same,
            "max_abs_err": err, "files": files}


def phase_graphs(cfg, params):
    """The three capture targets against their eager runs."""
    cache = OUT_DIR / "exec_cache"
    shutil.rmtree(cache, ignore_errors=True)
    out = {"serving": _graphs_serving(cfg, params, str(cache / "serving")),
           "fit": _graphs_fit(),
           "inference": _graphs_inference(str(cache / "inference"))}
    shutil.rmtree(cache, ignore_errors=True)
    return out


# -- phase 10: paged, int8 and drafting serving ----------------------------------
#: the paged server: phase 5's knobs, pages of 16 rows, and a pool of 129
#: pages (128 allocatable: half the dense worst case of 8 slots x 32 pages)
PAGED = dict(page_size=16, pool_pages=129, draft=2, steps=16)


def _greedy_continuation(cfg, params, prompt, n):
    """The first n greedy tokens after `prompt`, by the causal full
    forward."""
    ids = [int(t) for t in prompt]
    for _ in range(n):
        h = bert_encode(cfg, params, torch.as_tensor(ids, device=DEV)[None],
                        causal=True)
        ids.append(int(bert_mlm_logits(cfg, params, h[0, -1]).argmax()))
    return ids[len(prompt):]


def _draft_prompt(cfg, params, tries=16, rounds=6):
    """A prompt A + C + B of 113 tokens that holds its own continuation:
    C is the first three greedy tokens after A + C + B, found by iterating
    C to a fixed point. Prompt lookup then drafts C[1:] right after the
    prefill's token C[0]. Random weights seldom repeat a token, so without
    it drafting has nothing to accept."""
    rng = np.random.default_rng(6)
    for attempt in range(tries):
        a = rng.integers(1, cfg.vocab_size, 60)
        b = rng.integers(1, cfg.vocab_size, 50)
        c = _greedy_continuation(cfg, params, np.concatenate([a, b]), 3)
        for r in range(rounds):
            prompt = np.concatenate([a, c, b])
            nxt = _greedy_continuation(cfg, params, prompt, 3)
            if nxt == c:
                log(f"[paged] draft prompt: attempt {attempt}, round {r}, "
                    f"holds its continuation {c}")
                return prompt
            c = nxt
    raise AssertionError("paged: no prompt held its own continuation")


def _paged_requests(cfg, params):
    """12 requests: six share a 64-token system prompt (4 full pages) with
    distinct suffixes; requests 6 and 7 are identical (their tail page is
    shared, then copied on write); prompts run 5-120 tokens with 32-64 new
    tokens, greedy / temperature 0.8 / top-k 40 in turn; request 3 needs
    120 + 64 rows, so the cache grows to rung 512. Greedy request 9's
    prompt is `_draft_prompt`'s, which the drafting server drafts from."""
    rng = np.random.default_rng(3)
    system = rng.integers(1, cfg.vocab_size, 64)
    twin = rng.integers(1, cfg.vocab_size, 37)
    reqs = []
    for i in range(12):
        if i < 6:
            plen = 120 if i == 3 else int(rng.integers(69, 121))
            prompt = np.concatenate(
                [system, rng.integers(1, cfg.vocab_size, plen - 64)])
        elif i < 8:
            prompt = twin
        else:
            plen = 5 if i == 8 else int(rng.integers(5, 121))
            prompt = rng.integers(1, cfg.vocab_size, plen)
        new = 64 if i == 3 else int(rng.integers(32, 65))
        mode = ("greedy", "temperature", "top_k")[i % 3]
        if i == 9:
            prompt = _draft_prompt(cfg, params)
        reqs.append(dict(prompt=prompt, max_new_tokens=new, method=mode,
                         temperature=0.8,
                         top_k=40 if mode == "top_k" else 0))
    assert any(len(r["prompt"]) + r["max_new_tokens"] > 128 for r in reqs)
    return reqs


def _top2_gap(cfg, params, prompt, stream, j):
    """The margin of the greedy choice at generated token j: top-1 minus
    top-2 logit of the causal full forward over prompt + stream[:j]."""
    ids = torch.as_tensor(np.concatenate([prompt, stream[:j]]),
                          device=DEV)[None]
    h = bert_encode(cfg, params, ids, causal=True)
    top = bert_mlm_logits(cfg, params, h[0, -1]).topk(2).values
    return float(top[0] - top[1])


def _paged_server(cfg, params, reqs, what, check_launches=False, **kw):
    """One server over `reqs`: warmed up, counters at 0, every request
    through it, its store held clean; returns its run."""
    dkw = {k: kw.pop(k) for k in ("kv_dtype", "page_size", "pool_pages",
                                  "attn_impl") if k in kw}
    srv = GenerationServer(BertDecoder(cfg, params, **dkw),
                           **{**SERVER, **kw})
    try:
        srv.warmup()
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        streams = [h.result(timeout=600)
                   for h in [srv.submit(**r) for r in reqs]]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        srv.shutdown()
    # after the shutdown, which delivers the block still in flight: every
    # dispatched block is counted in the launches and in the status
    launches = _counts()
    st = srv.status()
    ntok = sum(len(s) for s in streams)
    run = {"server": what, "wall_s": wall, "tokens": ntok,
           "tokens_per_s": ntok / wall, "blocks": st["steps"],
           "admissions": st["admissions"],
           "token_fetches": st["token_fetches"],
           "per_token_p50_ms": st["per_token_p50_ms"],
           "per_token_p99_ms": st["per_token_p99_ms"],
           "launches": {k: launches[k] for k in ("flash_fwd",
                                                 "flash_decode")},
           "page_pool": st.get("page_pool"),
           "draft_accepts": st["draft_accepts"],
           "draft_rejects": st["draft_rejects"], "streams": streams}
    log(f"[paged] {what}: {ntok} tokens in {wall:.3f} s = "
        f"{ntok / wall:.1f} tokens/s; per-token p50 "
        f"{st['per_token_p50_ms']:.3f} ms p99 {st['per_token_p99_ms']:.3f} "
        f"ms; {st['steps']} blocks, {st['admissions']} admissions, "
        f"{st['token_fetches']} token fetches, rung {st['rung']}; launches "
        f"{run['launches']}" + (f"; pool {st['page_pool']}"
                                if st.get("page_pool") else "")
        + (f"; drafts accepted {st['draft_accepts']} rejected "
           f"{st['draft_rejects']}" if st["draft"] else ""))
    _store_clean(st["executables"], what)
    _fault_free(st, f"paged: {what}")
    if st["rung"] != 512:
        raise AssertionError(f"paged: {what} never grew to rung 512")
    if check_launches:
        missing = [k for k, n in run["launches"].items() if n == 0]
        if missing:
            raise AssertionError(f"paged: {what} never launched {missing}")
    return run


def _same(what, reqs, got, want, only=None):
    """Streams that must be equal (all, or those of the `only` indices)."""
    idx = range(len(reqs)) if only is None else only
    diff = [i for i in idx if got[i] != want[i]]
    if diff:
        raise AssertionError(f"paged: {what}: streams {diff} differ")


def _paged_exhaustion(cfg, params):
    """A pool of 3 pages (2 usable, 32 rows) at one rung of 128: a 3-page
    prompt is refused typed before dispatch, the server stays up and
    serves a 1-page prompt."""
    srv = GenerationServer(
        BertDecoder(cfg, params, page_size=PAGED["page_size"],
                    pool_pages=3),
        **{**SERVER, "cache_lengths": [128]})
    try:
        srv.warmup()
        rng = np.random.default_rng(4)
        big = srv.submit(rng.integers(1, cfg.vocab_size, 40),
                         max_new_tokens=8)
        try:
            big.result(timeout=600)
            raise AssertionError("paged: a 3-page prompt was admitted into "
                                 "a pool of 2 pages")
        except PagePoolExhaustedError as e:
            refused = repr(e)
        state = srv.serving_state()["state"]
        small = srv.generate(rng.integers(1, cfg.vocab_size, 9),
                             max_new_tokens=16, timeout=600)
        st = srv.status()
    finally:
        srv.shutdown()
    log(f"[paged] exhaustion: pool of 3 pages refused a 3-page prompt "
        f"({refused}); state {state}; then served a 1-page prompt "
        f"({len(small)} tokens); pool {st['page_pool']}")
    if state != "serving" or len(small) != 16:
        raise AssertionError(f"paged: exhaustion left the server {state}, "
                             f"{len(small)} tokens")
    _store_clean(st["executables"], "exhaustion")
    return {"refused": refused, "served_tokens": len(small),
            "page_pool": st["page_pool"]}


def _int8_logit_error(cfg, params):
    """int8 against fp decode of one prompt over PAGED['steps'] steps on
    the fp server's greedy tokens: the max relative logit error and the
    greedy agreement (printed, not gated)."""
    rng = np.random.default_rng(5)
    prompt = torch.as_tensor(rng.integers(1, cfg.vocab_size, 40),
                             device=DEV)
    padded = torch.cat([prompt, prompt.new_zeros(24)])
    decs = [BertDecoder(cfg, params), BertDecoder(cfg, params,
                                                  kv_dtype="int8")]
    caches = [d.init_cache(1, 128) for d in decs]
    logits = [d.prefill(d.model_args(), c, 0, padded, 40)[1][None]
              for d, c in zip(decs, caches)]
    pos = torch.tensor([40], device=DEV)
    err, agree = 0.0, 0
    for _ in range(PAGED["steps"]):
        err = max(err, ((logits[1] - logits[0]).abs().max()
                        / logits[0].abs().max()).item())
        agree += int(logits[1].argmax() == logits[0].argmax())
        tok = logits[0].argmax(dim=-1)
        logits = [d.step(d.model_args(), c, tok, pos)[0]
                  for d, c in zip(decs, caches)]
        pos = pos + 1
    log(f"[paged] int8 against fp decode, one 40-token prompt, "
        f"{PAGED['steps']} steps: max relative logit error {err:.3e}, "
        f"greedy agreement {agree}/{PAGED['steps']}")
    return {"max_rel_logit_err": err, "greedy_agree": agree,
            "steps": PAGED["steps"]}


def _paged_attention_times(cfg):
    """Card times of the plain-PyTorch pieces of the paged and int8 decode,
    beside flash_decode on the same rows: one layer at serving's decode
    shape (8 slots, 12 heads, C = 512, D = 64, f32), the gathers reading
    a pool of 257 pages of 16 rows (the kernel phase's decode case)."""
    b, h, c, d, ps = SERVER["slots"], cfg.num_heads, 512, cfg.head_dim, \
        PAGED["page_size"]
    n = c // ps
    gen = torch.Generator(device=DEV).manual_seed(9)
    kp = torch.randn((b * n + 1, h, ps, d), generator=gen, device=DEV)
    vp = torch.randn_like(kp)
    tab = (torch.randperm(b * n, generator=gen, device=DEV) + 1).reshape(
        b, n)
    q = torch.randn((b, h, 1, d), generator=gen, device=DEV)
    qm = torch.randn((b, h, PAGED["draft"] + 1, d), generator=gen,
                     device=DEV)
    mask = torch.ones((b, c), dtype=torch.bool, device=DEV)
    qmask = torch.ones((b, PAGED["draft"] + 1, c), dtype=torch.bool,
                       device=DEV)
    kc, vc = gather_kv_pages(kp, tab), gather_kv_pages(vp, tab)
    (k8, ks), (v8, vs) = quantize_rows(kc), quantize_rows(vc)
    kp8, ksp = quantize_rows(kp)
    vp8, vsp = quantize_rows(vp)
    f32 = 4
    rows = b * h * c
    cases = {
        "flash_decode (dense view)": (
            lambda: flash_decode(q, kc, vc, mask), 2 * rows * d * f32),
        "gather K and V pages": (
            lambda: (gather_kv_pages(kp, tab), gather_kv_pages(vp, tab)),
            4 * rows * d * f32),
        "paged fp decode (gather + flash_decode)": (
            lambda: flash_attention_decode_paged(q, kp, vp, tab, mask),
            2 * rows * d * f32),
        "int8 decode (scale-folding einsum)": (
            lambda: flash_attention_decode(q, k8, v8, mask, k_scale=ks,
                                           v_scale=vs),
            2 * rows * (d + f32)),
        "paged int8 decode (gathers + einsum)": (
            lambda: flash_attention_decode_paged(
                q, kp8, vp8, tab, mask, k_scale_pool=ksp,
                v_scale_pool=vsp), 2 * rows * (d + f32)),
        f"verify attention d={PAGED['draft'] + 1} (multi-query einsum)": (
            lambda: flash_attention_decode_mq(qm, kc, vc, qmask),
            2 * rows * d * f32),
    }
    out = {}
    for name, (fn, nbytes) in cases.items():
        ms = time_ms(fn)
        lo = nbytes / PEAK_BYTES_PER_S * 1e3
        out[name] = {"ms": ms, "bound_ms": lo, "bytes": nbytes}
        log(f"[paged] {name} 8x12 C=512 D=64: {ms:.4f} ms, bytes bound "
            f"{lo:.5f} ms")
    return out


def phase_paged(cfg, params):
    """bert_base served from a page pool (fp and int8) and with greedy
    drafting, each against its dense counterpart, the dense fp server in
    turns as the control; pool exhaustion on a small pool; the int8 codec's
    logit error; the card times of the paged and int8 attention pieces."""
    reqs = _paged_requests(cfg, params)
    greedy = [i for i, r in enumerate(reqs) if r["method"] == "greedy"]
    pg = dict(page_size=PAGED["page_size"], pool_pages=PAGED["pool_pages"])
    runs = [_paged_server(cfg, params, reqs, "dense fp (control)")]
    runs.append(_paged_server(cfg, params, reqs, "paged fp",
                              check_launches=True, **pg))
    _same("paged fp against dense fp", reqs, runs[1]["streams"],
          runs[0]["streams"])
    occ = runs[1]["page_pool"]
    if occ["prefix_hits"] < 5 or occ["cow_copies"] < 1 \
            or occ["pages_mapped"] != 0:
        raise AssertionError(f"paged: pool counters {occ}")
    runs.append(_paged_server(cfg, params, reqs, "dense int8",
                              kv_dtype="int8"))
    runs.append(_paged_server(cfg, params, reqs, "paged int8",
                              kv_dtype="int8", **pg))
    _same("paged int8 against dense int8", reqs, runs[3]["streams"],
          runs[2]["streams"])
    runs.append(_paged_server(cfg, params, reqs, "paged fp, draft=2",
                              draft=PAGED["draft"], superstep=1, **pg))
    draft = runs[-1]
    diff = [i for i in greedy if draft["streams"][i] != runs[0]["streams"][i]]
    if diff:
        i = diff[0]
        a, b = draft["streams"][i], runs[0]["streams"][i]
        j = next(t for t in range(len(b)) if a[t] != b[t])
        gap = _top2_gap(cfg, params, reqs[i]["prompt"], b, j)
        raise AssertionError(f"paged: drafted greedy streams {diff} differ "
                             f"from the undrafted ones; request {i} first "
                             f"at token {j} ({a[j]} against {b[j]}), whose "
                             f"top-2 logit gap is {gap:.3e}")
    if draft["draft_accepts"] <= 0:
        raise AssertionError("paged: the drafting server accepted no draft")
    sampled_same = sum(draft["streams"][i] == runs[0]["streams"][i]
                       for i in range(len(reqs)) if i not in greedy)
    runs.append(_paged_server(cfg, params, reqs, "dense fp (control, "
                              "again)"))
    _same("the two dense fp controls", reqs, runs[-1]["streams"],
          runs[0]["streams"])
    int8_vs_fp = sum(runs[2]["streams"][i] == runs[0]["streams"][i]
                     for i in greedy)
    log(f"[paged] greedy streams: paged fp = dense fp, paged int8 = dense "
        f"int8 (all 12 each), drafted = undrafted {len(greedy)}/"
        f"{len(greedy)}; drafted sampled streams equal to undrafted "
        f"{sampled_same}/{len(reqs) - len(greedy)}; int8 greedy streams "
        f"equal to fp {int8_vs_fp}/{len(greedy)}")
    layers, heads, hd = cfg.num_layers, cfg.num_heads, cfg.head_dim
    pool_bytes = {kv: PAGED["pool_pages"] * cache_page_bytes(
        layers, heads, PAGED["page_size"], hd, kv) for kv in ("fp", "int8")}
    rows = SERVER["slots"] * sum(SERVER["cache_lengths"])
    dense_bytes = {kv: rows // PAGED["page_size"] * cache_page_bytes(
        layers, heads, PAGED["page_size"], hd, kv) for kv in ("fp", "int8")}
    log(f"[paged] cache bytes: pool of {PAGED['pool_pages']} pages fp "
        f"{pool_bytes['fp']} / int8 {pool_bytes['int8']}; dense caches "
        f"(8 slots, rungs 128 + 512) fp {dense_bytes['fp']} / int8 "
        f"{dense_bytes['int8']}")
    exhaustion = _paged_exhaustion(cfg, params)
    int8_err = _int8_logit_error(cfg, params)
    times = _paged_attention_times(cfg)
    for r in runs:
        del r["streams"]
    return {"runs": runs, "exhaustion": exhaustion, "int8_logits": int8_err,
            "attention_ms": times, "pool_bytes": pool_bytes,
            "dense_cache_bytes": dense_bytes,
            "drafted_sampled_identical": sampled_same,
            "int8_greedy_equal_fp": int8_vs_fp}


# -- phase 11: chaos ----------------------------------------------------------
#: the chaos phase: phase 5's server and 12 requests, f32, through the
#: graphs. Fault calls count visits to each site in one run: admissions
#: 1-8 fill the 8 slots, blocks are numbered from the first.
CHAOS = dict(kill_blocks=(3, 9), kill_admission=4, relief_steps=32,
             budget_attempts=2, release_s=1.0,
             monitoring_arms=("off", "on", "on", "off") * 2)


def _cuda_oom(site, call_n):
    """An OOM of the shape torch.cuda.OutOfMemoryError reports."""
    return RuntimeError(f"CUDA out of memory. Tried to allocate 2.00 GiB "
                        f"(injected at {site}, call {call_n})")


def _stamped(make, stamps):
    """A FaultPlan exception factory that notes when each fault fired."""
    def exc(site, call_n):
        stamps.append((time.perf_counter(), site, call_n))
        return make(site, call_n)
    return exc


def _chaos_server(cfg, params, reqs, what, plan=None, dec_kw=None,
                  monitoring=False, stamps=False, after_warmup=None,
                  **kw):
    """One server over `reqs`, warmed up, counters at 0, with `plan`
    installed around the workload; each request resolves to its stream or
    its exception. Returns the run, with the store's counters after the
    warm-up and at the end."""
    srv = GenerationServer(BertDecoder(cfg, params, **(dec_kw or {})),
                           **{**SERVER, **kw})
    mon.disable()
    ev.reset()
    delivered = []
    try:
        srv.warmup()
        torch.cuda.synchronize()
        if after_warmup is not None:
            after_warmup(srv)
        warm = dict(srv._store.stats)
        if monitoring:
            mon.enable()
        _reset_counts()
        t0 = time.perf_counter()
        if plan is not None:
            faults.install_plan(plan)
        try:
            hs = []
            for i, r in enumerate(reqs):
                cb = ((lambda tok, i=i: delivered.append(
                    (time.perf_counter(), i))) if stamps else None)
                hs.append(srv.submit(**r, on_token=cb))
            out = []
            for h in hs:
                try:
                    out.append(h.result(timeout=600))
                except Exception as e:  # noqa: BLE001 — gated by callers
                    out.append(e)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            faults.clear_plan()
        events = ev.snapshot(last=None)["events"]
        state = srv.serving_state()
    finally:
        mon.disable()
        srv.shutdown()
    launches = _counts()
    st = srv.status()
    ntok = sum(len(s) for s in out if isinstance(s, list))
    run = {"server": what, "wall_s": wall, "tokens": ntok,
           "tokens_per_s": ntok / wall,
           "per_token_p50_ms": st["per_token_p50_ms"],
           "per_token_p99_ms": st["per_token_p99_ms"],
           "launches": {k: launches[k] for k in ("flash_fwd",
                                                 "flash_decode")},
           **{k: st[k] for k in ("steps", "admissions", "replays",
                                 "restarts", "errors", "degradations",
                                 "blocks_dropped", "token_fetches")},
           "state": state, "store_after_warmup": warm,
           "store": st["executables"], "fired": (None if plan is None
                                                 else dict(plan.fired))}
    log(f"[chaos] {what}: {ntok} tokens in {wall:.3f} s = "
        f"{ntok / wall:.1f} tokens/s; {st['steps']} blocks, "
        f"{st['admissions']} admissions, {st['replays']} replays, "
        f"{st['restarts']} restarts, {st['blocks_dropped']} blocks dropped, "
        f"{st['token_fetches']} fetches; state {state['state']}; launches "
        f"{run['launches']}" + (f"; fired {run['fired']}" if plan else ""))
    return run, out, events, delivered, srv, hs


def _recovery_clean(run, what):
    """No capture, rebind, degradation, live capture or eager call after
    the warm-up: recovery ran from the warm graphs; and each fetch is a
    delivered block, an admission or a replay."""
    a, b = run["store_after_warmup"], run["store"]
    moved = {k: b[k] - a[k] for k in ("captures", "rebinds",
                                      "degradations", "live_captures",
                                      "eager_calls", "compiled")
             if b[k] != a[k]}
    if moved or not b["capture"] or b["replays"] == a["replays"]:
        raise AssertionError(f"chaos: {what}: the store moved after its "
                             f"warm-up: {moved or b}")
    want = run["steps"] + run["admissions"] + run["replays"]
    if run["token_fetches"] != want:
        raise AssertionError(f"chaos: {what}: {run['token_fetches']} "
                             f"fetches for {want} blocks, admissions and "
                             f"replays")


def _streams_equal(what, got, want, only=None):
    idx = range(len(want)) if only is None else only
    bad = [i for i in idx if got[i] != want[i]]
    if bad:
        raise AssertionError(f"chaos: {what}: streams {bad} differ from "
                             f"the fault-free run's ({got[bad[0]]!r})")


def _replay_points(events, handles):
    """(request index, mode, delivered) of each SERVER_REPLAY event."""
    index = {h.trace_id: i for i, h in enumerate(handles)}
    return [(index.get(e["attrs"]["request"]), e["attrs"]["mode"],
             e["attrs"]["delivered"]) for e in events
            if e["kind"] == ev.SERVER_REPLAY]


@torch.no_grad()
def _replay_logit_gap(cfg, params, req, stream, g):
    """At a prefix replay point (g tokens delivered): the logits of token
    g as the uninterrupted run computed them — a prefill, then g decode
    steps through flash_decode — against the replay's prefill of
    prompt + stream[:g] through flash_fwd. Returns the largest |Δlogit|
    and the top-1 minus top-2 margin of the decode path's logits."""
    dec = BertDecoder(cfg, params)
    margs = dec.model_args()
    prompt = np.asarray(req["prompt"], np.int64)
    plen = len(prompt)
    rung = next(c for c in SERVER["cache_lengths"]
                if c >= plen + req["max_new_tokens"])

    def prefill(ids):
        bucket = next(p for p in SERVER["prompt_buckets"] if p >= len(ids))
        padded = np.zeros(bucket, np.int64)
        padded[:len(ids)] = ids
        cache = dec.init_cache(1, rung)
        _, logits = dec.prefill(margs, cache, 0,
                                torch.as_tensor(padded, device=DEV),
                                len(ids))
        return cache, logits

    cache, _ = prefill(prompt)
    for j in range(g):
        tok = torch.tensor([stream[j]], device=DEV)
        pos = torch.tensor([plen + j], device=DEV)
        step_logits, cache = dec.step(margs, cache, tok, pos)
    _, replay_logits = prefill(np.concatenate([prompt, stream[:g]]))
    a, b = step_logits[0].float(), replay_logits.float()
    top = a.topk(2).values
    return float((a - b).abs().max()), float(top[0] - top[1])


def _case_line(case, run, keys):
    """One JSON line for a chaos case: the numbers that its gate read."""
    print(json.dumps({"chaos": case, **{k: run.get(k) for k in keys}},
                     default=str), flush=True)


def _chaos_kills(cfg, params, reqs, want):
    """Two block kills and one admission kill on the dense server."""
    stamps = []
    exc = _stamped(faults._default_exc, stamps)
    plan = faults.FaultPlan(seed=12)
    for n in CHAOS["kill_blocks"]:
        plan.fail_at(faults.GENERATION_SUPERSTEP, n, exc=exc)
    plan.fail_at(faults.GENERATION_ADMIT, CHAOS["kill_admission"], exc=exc)
    run, out, events, delivered, srv, hs = _chaos_server(
        cfg, params, reqs, "dense kills", plan=plan, monitoring=True,
        stamps=True)
    _streams_equal("dense kills", out, want)
    _recovery_clean(run, "dense kills")
    if run["fired"] != {faults.GENERATION_SUPERSTEP: 2,
                        faults.GENERATION_ADMIT: 1}:
        raise AssertionError(f"chaos: dense kills fired {run['fired']}")
    if not 1 <= run["blocks_dropped"] <= 2:
        raise AssertionError(f"chaos: dense kills dropped "
                             f"{run['blocks_dropped']} blocks")
    missing = [k for k, n in run["launches"].items() if n == 0]
    if missing:
        raise AssertionError(f"chaos: dense kills never launched {missing}")
    recovery_ms = []
    for t, site, call_n in stamps:
        after = [d for d, _ in delivered if d > t]
        if not after:
            raise AssertionError(f"chaos: no token after the fault at "
                                 f"{site} call {call_n}")
        recovery_ms.append({"site": site, "call": call_n,
                            "ms": (min(after) - t) * 1e3})
    points = _replay_points(events, hs)
    modes = {m: sum(1 for _, mm, _ in points if mm == m)
             for m in ("prefix", "regenerate")}
    if len(points) != run["replays"] or None in [i for i, _, _ in points]:
        raise AssertionError(f"chaos: replay events {points} against "
                             f"{run['replays']} replays")
    gaps = []
    for i, mode, g in points:
        if mode != "prefix" or g == 0:
            continue
        err, margin = _replay_logit_gap(cfg, params, reqs[i], want[i], g)
        gaps.append({"request": i, "delivered": g, "max_abs_dlogit": err,
                     "decode_top2_margin": margin})
    kinds = [e["kind"] for e in events]
    if ev.SERVER_DISRUPTED not in kinds or ev.SERVER_RECOVERED not in kinds:
        raise AssertionError(f"chaos: dense kills emitted {kinds}")
    run.update(recovery_ms=recovery_ms, replay_modes=modes,
               replay_points=[list(p) for p in points],
               replay_logit_gaps=gaps,
               max_abs_dlogit=max((x["max_abs_dlogit"] for x in gaps),
                                  default=None))
    log(f"[chaos] dense kills: streams equal the fault-free run's; "
        f"replays {modes}; fault to next delivered token "
        + ", ".join(f"{r['site']}#{r['call']} {r['ms']:.2f} ms"
                    for r in recovery_ms)
        + f"; largest |dlogit| at {len(gaps)} prefix replay points "
        f"{run['max_abs_dlogit']}; store after warm-up: no capture, "
        f"rebind, degradation or eager call")
    return run


def _chaos_paged(cfg, params, reqs, want):
    """A cache.page fault mid-stream on the paged server."""
    plan = faults.FaultPlan(seed=13).fail_at(faults.CACHE_PAGE, 20)
    run, out, _, _, _, _ = _chaos_server(
        cfg, params, reqs, "paged cache.page kill", plan=plan,
        dec_kw=dict(page_size=PAGED["page_size"],
                    pool_pages=PAGED["pool_pages"]))
    _streams_equal("paged kill", out, want)
    _recovery_clean(run, "paged kill")
    mapped = run["state"]["page_pool"]["pages_mapped"]
    if run["fired"] != {faults.CACHE_PAGE: 1} or run["replays"] < 1 \
            or mapped != 0:
        raise AssertionError(f"chaos: paged kill fired {run['fired']}, "
                             f"{run['replays']} replays, {mapped} pages "
                             f"mapped at the end")
    return run


def _chaos_ladder(cfg, params, reqs, want):
    """An OOM-shaped fault at the growth to rung 512: the growing request
    is refused typed, the rest are served, and the pressure relieves."""
    plan = faults.FaultPlan(seed=14).fail_at(faults.CACHE_GROW, 1,
                                             exc=_cuda_oom)
    run, out, _, _, srv, _ = _chaos_server(
        cfg, params, reqs, "ladder (OOM at growth)", plan=plan,
        pressure_relief_steps=CHAOS["relief_steps"],
        pressure_relief_secs=None)
    refused = [i for i, s in enumerate(out)
               if isinstance(s, MemoryPressureError)]
    other = [i for i, s in enumerate(out)
             if not isinstance(s, (list, MemoryPressureError))]
    served = [i for i, s in enumerate(out) if isinstance(s, list)]
    _streams_equal("ladder", out, want, only=served)
    if 3 not in refused or other or run["degradations"] < 2 \
            or run["state"]["state"] != "serving" \
            or run["state"]["pressure"] != 0:
        raise AssertionError(f"chaos: ladder refused {refused}, other "
                             f"errors {other}, state {run['state']}")
    run.update(refused=refused, served=len(served))
    log(f"[chaos] ladder: requests {refused} refused typed "
        f"(MemoryPressureError), {len(served)} served equal to the "
        f"fault-free run; {run['degradations']} degradations; relieved to "
        f"{run['state']['state']} after {CHAOS['relief_steps']} clean "
        f"tokens")
    return run


def _chaos_high_water(cfg, params, reqs, want):
    """memory_high_water just under the reading after the warm-up: the
    telemetry refuses the growth to rung 512."""
    reading = {}

    def set_mark(srv):
        stats = next(iter(_mem.device_memory_stats(srv.device).values()))
        reading.update(stats)
        reading["fraction"] = stats["bytes_in_use"] / stats["bytes_limit"]
        srv.memory_high_water = reading["fraction"] - 1e-3

    run, out, _, _, _, _ = _chaos_server(
        cfg, params, reqs, "high water", after_warmup=set_mark,
        pressure_relief_steps=1 << 30, pressure_relief_secs=None)
    refused = [i for i, s in enumerate(out)
               if isinstance(s, MemoryPressureError)
               and "high-water" in str(s)]
    served = [i for i, s in enumerate(out) if isinstance(s, list)]
    _streams_equal("high water", out, want, only=served)
    if 3 not in refused or len(refused) + len(served) != len(reqs) \
            or run["errors"] or run["state"]["state"] != "degraded":
        raise AssertionError(f"chaos: high water refused {refused}, "
                             f"served {served}, {run['errors']} errors, "
                             f"state {run['state']}")
    run.update(refused=refused, served=len(served), reading=reading)
    log(f"[chaos] high water: device memory after the warm-up "
        f"{reading['bytes_in_use']} of {reading['bytes_limit']} bytes "
        f"({reading['fraction']:.4f}; allocator: allocated "
        f"{reading.get('allocated_bytes')}, reserved "
        f"{reading.get('reserved_bytes')}); mark set to "
        f"{reading['fraction'] - 1e-3:.4f}: growth refused for {refused}, "
        f"{len(served)} served; state degraded")
    return run


def _chaos_budget(cfg, params, reqs):
    """Every admission faults: the restart budget runs out and latches
    ServerDeadError; every open consumer is released within a second."""
    stamps = []
    plan = faults.FaultPlan(seed=15).every(
        faults.GENERATION_ADMIT, 1, exc=_stamped(faults._default_exc, stamps))
    srv = GenerationServer(BertDecoder(cfg, params), **SERVER,
                           restart_policy=RetryPolicy(
                               max_attempts=CHAOS["budget_attempts"],
                               initial_backoff=0.01, max_backoff=0.02))
    released = [None] * len(reqs)
    try:
        srv.warmup()
        with plan:
            hs = [srv.submit(**r) for r in reqs]

            def consume(i):
                try:
                    for _ in hs[i].stream(timeout=60):
                        pass
                except ServerDeadError:
                    released[i] = time.perf_counter()

            threads = [threading.Thread(target=consume, args=(i,))
                       for i in range(len(hs))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=90)
        state = srv.serving_state()["state"]
        restarts = srv.stats["restarts"]
    finally:
        srv.shutdown()
    if None in released or state != "dead":
        raise AssertionError(f"chaos: budget: state {state}, consumers "
                             f"released {released}")
    latest = max(released) - stamps[-1][0]
    log(f"[chaos] restart budget: {len(stamps)} admission faults, "
        f"{restarts} restarts, then ServerDeadError; all {len(hs)} "
        f"consumers released, the last {latest * 1e3:.2f} ms after the "
        f"last fault")
    if latest > CHAOS["release_s"]:
        raise AssertionError(f"chaos: budget: a consumer waited "
                             f"{latest:.3f} s")
    return {"faults": len(stamps), "restarts": restarts,
            "release_ms": latest * 1e3, "state": state}


def phase_chaos(cfg, params):
    """Phase 5's server and workload under injected faults: streams equal
    the fault-free run's, recovery from the warm graphs, the
    memory-pressure ladder, the restart budget, and what monitoring
    costs."""
    torch.cuda.empty_cache()    # earlier phases' cached blocks
    reqs = _requests(cfg)
    arms = []
    for arm in CHAOS["monitoring_arms"]:
        run, out, _, _, _, _ = _chaos_server(
            cfg, params, reqs, f"fault-free, monitoring {arm}",
            monitoring=arm == "on")
        if any(not isinstance(s, list) for s in out):
            raise AssertionError(f"chaos: fault-free run failed: {out}")
        _fault_free(run, f"chaos: fault-free, monitoring {arm}")
        if arms:
            _streams_equal(f"monitoring {arm}", out, arms[0][1])
        run["monitoring"] = arm
        arms.append((run, out))
    want = arms[0][1]
    tps = {a: [r["tokens_per_s"] for r, _ in arms if r["monitoring"] == a]
           for a in ("off", "on")}
    ratio = float(np.median(tps["on"]) / np.median(tps["off"]))
    log(f"[chaos] tokens/s, monitoring off {tps['off']} / on {tps['on']} "
        f"(in turns off, on, on, off, twice); median on / median off "
        f"{ratio:.4f}")
    for run, _ in arms:
        _case_line(f"fault-free, monitoring {run['monitoring']}", run,
                   ("tokens", "wall_s", "tokens_per_s", "per_token_p50_ms",
                    "per_token_p99_ms", "steps", "admissions", "launches"))
    kills = _chaos_kills(cfg, params, reqs, want)
    _case_line("dense kills", kills,
               ("fired", "replays", "replay_modes", "restarts",
                "blocks_dropped", "recovery_ms", "max_abs_dlogit",
                "replay_logit_gaps", "launches", "tokens_per_s"))
    paged = _chaos_paged(cfg, params, reqs, want)
    _case_line("paged cache.page kill", paged,
               ("fired", "replays", "blocks_dropped", "launches",
                "tokens_per_s"))
    ladder = _chaos_ladder(cfg, params, reqs, want)
    _case_line("ladder", ladder, ("fired", "refused", "served",
                                  "degradations", "replays", "state"))
    high = _chaos_high_water(cfg, params, reqs, want)
    _case_line("high water", high, ("refused", "served", "degradations",
                                    "reading", "state"))
    budget = _chaos_budget(cfg, params, reqs)
    _case_line("restart budget", budget, ("faults", "restarts",
                                          "release_ms", "state"))
    return {"monitoring": [r for r, _ in arms], "tokens_per_s": tps,
            "monitoring_on_over_off": ratio,
            "kills": kills, "paged": paged, "ladder": ladder,
            "high_water": high, "budget": budget}


# -- phase 12 -----------------------------------------------------------------
#: three replicas of serving's server on the one card, over one parameter
#: set and one manifest directory; the workload is `_requests(cfg)` twice
#: (24 requests in order; requests 3 and 15 grow to rung 512). Replicas die
#: on their first failed block (`max_consecutive_failures=0`), so a fault
#: is the fleet's to recover. The kill is the block site of a superstep-4
#: server (`generation.superstep`; the k=1 path's `generation.step` never
#: fires there).
FLEET = dict(replicas=3, kill_block=12, dispatch_every=5, failover_budget=6,
             memory_slack=0.10, arms=("single", "fleet", "fleet", "single"),
             http=("/fleet", "/health", "/generation", "/metrics",
                   "/events", "/incidents", "/requests", "/executables"))


def _fleet_factory(cfg, params, cache_dir, builds):
    """The replicas' factory, which is also the supervisor's replacement
    builder. Each build notes, in `builds`, the allocated bytes when it was
    built and its warm-up's window and counts."""
    def factory(i):
        rec = {"index": i, "built": time.perf_counter(),
               "allocated_at_build": torch.cuda.memory_allocated()}
        srv = GenerationServer(BertDecoder(cfg, params),
                               exec_cache_dir=cache_dir,
                               max_consecutive_failures=0, **SERVER)
        warm = srv.warmup

        def warmup():
            rec["t0"] = time.perf_counter()
            out = warm()
            rec["t1"] = time.perf_counter()
            rec.update({k: out[k] for k in ("compiled", "from_disk",
                                            "captures", "executables")},
                       seconds=rec["t1"] - rec["t0"])
            return out

        srv.warmup = warmup
        builds.append(rec)
        return srv
    return factory


def _http(port, path):
    """GET a UIServer route: (status, parsed body)."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            code, body, ctype = r.status, r.read(), r.headers["Content-Type"]
    except urllib.error.HTTPError as e:
        code, body, ctype = e.code, e.read(), e.headers["Content-Type"]
    if ctype.startswith("application/json"):
        return code, json.loads(body)
    return code, body.decode()


def _fleet_single(cfg, params, cache_dir, reqs):
    """One bare server over the workload: the streams the fleet must give."""
    srv = GenerationServer(BertDecoder(cfg, params), exec_cache_dir=cache_dir,
                           **SERVER)
    try:
        srv.warmup()
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        hs = [srv.submit(**r) for r in reqs]
        out = [h.result(timeout=600) for h in hs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        srv.shutdown()
    _fault_free(srv.status(), "fleet: single server")
    ntok = sum(len(x) for x in out)
    return out, {"arm": "single", "tokens": ntok, "wall_s": wall,
                 "tokens_per_s": ntok / wall, "launches": _counts()}


def _fleet_run(cfg, params, cache_dir, reqs, what, plan=None,
               monitoring=False, during=None, after=None, **router_kw):
    """Build and warm a fleet, then submit `reqs` in order (each token
    stamped) with `plan` installed, and wait for every request, which
    resolves to its stream or its exception. `during(router)` runs while
    the requests are in flight, `after(router)` once they are done, before
    the shutdown. Returns the run and the streams."""
    from deeplearning4j_tpu_torch.generation import FleetRouter
    builds = []
    router = FleetRouter(factory=_fleet_factory(cfg, params, cache_dir,
                                                builds),
                         num_replicas=FLEET["replicas"], **router_kw)
    mon.disable()
    ev.reset()
    stamps, faulted = [], []
    run = {"fleet": what}
    try:
        router.warmup()
        torch.cuda.synchronize()
        first = len(builds)
        if monitoring:
            mon.enable()
        _reset_counts()
        gc.collect()                # servers of earlier runs hold cycles
        run["allocated_before"] = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        if plan is not None:
            faults.install_plan(plan)
        try:
            hs = [router.submit(**r, on_token=lambda tok, i=i: stamps.append(
                (time.perf_counter(), i))) for i, r in enumerate(reqs)]
            if during is not None:
                run["during"] = during(router)
            out = []
            for h in hs:
                try:
                    out.append(h.result(timeout=600))
                except Exception as e:  # noqa: BLE001 — gated by callers
                    out.append(e)
            wall = time.perf_counter() - t0
            # a reviver may still be at work: no device-wide synchronize
            # while a replacement captures
            while any(r.reviving for r in router._replicas):
                time.sleep(0.01)
            torch.cuda.synchronize()
            if after is not None:
                run["after"] = after(router)
        finally:
            faults.clear_plan()
        gc.collect()
        torch.cuda.synchronize()
        run["allocated_after"] = torch.cuda.memory_allocated()
        st = router.status()
        stores = [dict(r.server._store.stats) for r in router._replicas]
        events = ev.snapshot(last=None)["events"]
        incidents = ev.incidents()
        state = router.fleet_state()
    finally:
        mon.disable()
        router.shutdown()
    servers = [r.server.status() for r in router._replicas]
    del router
    gc.collect()
    ntok = sum(len(x) for x in out if isinstance(x, list))
    run.update(
        tokens=ntok, wall_s=wall, tokens_per_s=ntok / wall,
        launches=_counts(), routed=[r["routed"] for r in st["replicas"]],
        healths=[r["health"] for r in st["replicas"]],
        state=state["state"], stores=stores, servers=servers,
        replacement_builds=builds[first:], handles=hs, stamps=stamps,
        events=events, incidents=incidents,
        fired=None if plan is None else dict(plan.fired),
        **{k: st[k] for k in ("submitted", "completed", "failed",
                              "failovers", "shed", "replacements")})
    log(f"[fleet] {what}: {ntok} tokens in {wall:.3f} s = "
        f"{ntok / wall:.1f} tokens/s; routed {run['routed']}; failovers "
        f"{run['failovers']}, replacements {run['replacements']}, failed "
        f"{run['failed']}, shed {run['shed']}; state {run['state']}; "
        f"launches flash_fwd {run['launches']['flash_fwd']} flash_decode "
        f"{run['launches']['flash_decode']}"
        + (f"; fired {run['fired']}" if plan is not None else ""))
    return run, out


def _fleet_streams(what, got, want):
    bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    if bad or len(got) != len(want):
        raise AssertionError(f"fleet: {what}: requests {bad} differ from "
                             f"the single server's ({got[bad[0]]!r})")


def _fleet_stores_clean(run, what):
    """No replica captured live, ran a key eagerly or degraded one after its
    warm-up, and every one replays graphs."""
    bad = [s for s in run["stores"] if s["live_captures"]
           or s["eager_calls"] or s["degradations"] or not s["replays"]]
    if bad:
        raise AssertionError(f"fleet: {what}: a store moved after its "
                             f"warm-up: {bad}")


def _fleet_probe(port):
    """During the fault-free run: every route answers 200 with a body that
    parses; /fleet lists three replicas and /health the fleet serving."""
    out = {}
    for path in FLEET["http"]:
        code, body = _http(port, path)
        if code != 200 or (path != "/metrics" and not isinstance(body,
                                                                  dict)):
            raise AssertionError(f"fleet: GET {path} answered {code}")
        out[path] = code
    routers = _http(port, "/fleet")[1]["routers"]
    health = _http(port, "/health")[1]
    if not any(len(r["replicas"]) == FLEET["replicas"] for r in routers) \
            or health["status"] != "ok" \
            or not any(f["state"] == "serving" for f in health["fleet"]):
        raise AssertionError(f"fleet: /fleet {routers} /health {health}")
    return out


def _fleet_kill(cfg, params, cache_dir, reqs, want):
    """A replica killed mid-stream: its requests fail over, the supervisor
    replaces it from the manifest while the survivors serve, and the dead
    server's memory is released."""
    fault_t = []
    plan = faults.FaultPlan(seed=21).fail_at(
        faults.GENERATION_SUPERSTEP, FLEET["kill_block"],
        exc=_stamped(faults._default_exc, fault_t))
    run, out = _fleet_run(cfg, params, cache_dir, reqs, "replica killed",
                          plan=plan, monitoring=True)
    _fleet_streams("replica killed", out, want)
    if run["fired"] != {faults.GENERATION_SUPERSTEP: 1} \
            or run["failovers"] < 1 or run["replacements"] != 1 \
            or run["failed"] or run["shed"] or run["state"] != "serving":
        raise AssertionError(f"fleet: replica killed: {run['fired']}, "
                             f"{run['failovers']} failovers, "
                             f"{run['replacements']} replacements, "
                             f"{run['failed']} failed, state {run['state']}")
    _fleet_stores_clean(run, "replica killed")
    (rep,) = run["replacement_builds"]
    if rep["compiled"] != 0 or rep["from_disk"] != rep["executables"] \
            or not rep["from_disk"]:
        raise AssertionError(f"fleet: the replacement did not warm from the "
                             f"manifest: {rep}")
    inc = [i for i in run["incidents"]["recent"] + run["incidents"]["open"]
           if ev.REPLICA_REPLACED in i["kinds"]]
    kinds = inc[0]["kinds"] if inc else []
    if not inc or inc[0]["state"] != "resolved" or not (
            kinds.index(ev.REPLICA_UNHEALTHY) < kinds.index(ev.REPLICA_DRAINED)
            < kinds.index(ev.REPLICA_REPLACED)):
        raise AssertionError(f"fleet: replica killed: incident {inc}")
    before, after = run["allocated_before"], run["allocated_after"]
    if after > before * (1 + FLEET["memory_slack"]):
        raise AssertionError(f"fleet: the dead replica's memory was not "
                             f"released: {before} bytes before the kill, "
                             f"{after} after the replacement")
    # each failover names its request and the tokens it had delivered:
    # the next token is the first of the continuation on another replica
    t_fault = fault_t[0][0]
    index = {h.trace_id: i for i, h in enumerate(run["handles"])}
    moved, next_ms = [], []
    for e in run["events"]:
        if e["kind"] != ev.REQUEST_FAILOVER:
            continue
        i, g = index[e["attrs"]["request"]], e["attrs"]["delivered"]
        times = [t for t, j in run["stamps"] if j == i]
        moved.append(i)
        next_ms.append((times[g] - t_fault) * 1e3)
    if len(moved) != run["failovers"]:
        raise AssertionError(f"fleet: replica killed: {len(moved)} "
                             f"failover events for {run['failovers']} "
                             f"failovers")
    window = rep["t1"] - rep["t0"]
    during = sum(1 for t, _ in run["stamps"] if rep["t0"] <= t <= rep["t1"])
    run.update(failed_over=moved, fault_to_next_token_ms=next_ms,
               replacement_warmup_s=window,
               survivor_tokens_per_s_during_warmup=during / window,
               allocated_at_replacement=rep["allocated_at_build"],
               incident=kinds)
    log(f"[fleet] replica killed: streams equal the single server's; "
        f"{len(moved)} requests failed over; fault -> their next token "
        f"{min(next_ms):.1f}-{max(next_ms):.1f} ms; the replacement warmed "
        f"in {window:.3f} s (compiled {rep['compiled']}, from_disk "
        f"{rep['from_disk']}), survivors {during} tokens in that window = "
        f"{during / window:.1f} tokens/s; allocated bytes before the kill "
        f"{before}, at the replacement's build {rep['allocated_at_build']},"
        f" after it {after}; incident {' -> '.join(kinds)}")
    return run


def _fleet_restart_fault(cfg, params, cache_dir, reqs, want, port):
    """A replacement that itself fails: the slot stays dead, the fleet
    serves on degraded; FleetDeadError only once no live replica remains."""
    from deeplearning4j_tpu_torch.resilience.errors import FleetDeadError
    plan = (faults.FaultPlan(seed=23)
            .fail_at(faults.GENERATION_SUPERSTEP, FLEET["kill_block"])
            .every(faults.REPLICA_RESTART, 1))

    def after(router):
        healths = sorted(r.health(router._clock()) for r in router._replicas)
        code, health = _http(port, "/health")
        fleet = [f for f in health["fleet"] if f["state"] != "serving"]
        seen = {"healths": healths, "health": code,
                "status": health["status"],
                "fleet": fleet[0]["state"] if fleet else None}
        live = [r for r in router._replicas if r.server._dead is None
                and not r.server._shutdown]
        for r in live[:-1]:
            r.server._die(RuntimeError("chip_smoke: survivor killed"))
            router.submit(**{**reqs[0], "max_new_tokens": 4}).result(
                timeout=60)
            if router._dead is not None:
                raise AssertionError("fleet: latched with a live replica")
        live[-1].server._die(RuntimeError("chip_smoke: last replica killed"))
        try:
            router.submit(**{**reqs[0], "max_new_tokens": 4}).result(
                timeout=60)
            seen["latched"] = None
        except FleetDeadError as e:
            seen["latched"] = type(e).__name__
        code, health = _http(port, "/health")
        seen.update(dead_health=code, dead_status=health["status"])
        return seen

    run, out = _fleet_run(cfg, params, cache_dir, reqs, "restart fault",
                          plan=plan, after=after)
    _fleet_streams("restart fault", out, want)
    seen = run["after"]
    if run["replacements"] or run["fired"].get(faults.REPLICA_RESTART, 0) < 1 \
            or seen["healths"] != ["dead", "healthy", "healthy"] \
            or seen["health"] != 200 or seen["status"] != "degraded" \
            or seen["fleet"] != "degraded" \
            or seen["latched"] != "FleetDeadError" \
            or seen["dead_health"] != 503 \
            or seen["dead_status"] != "serving_dead":
        raise AssertionError(f"fleet: restart fault: {run['fired']}, "
                             f"{run['replacements']} replacements, {seen}")
    log(f"[fleet] restart fault: the slot stayed dead, streams equal; "
        f"/health {seen['health']} {seen['status']} (fleet "
        f"{seen['fleet']}); with every replica dead: {seen['latched']}, "
        f"/health {seen['dead_health']} {seen['dead_status']}")
    return run


def phase_fleet(cfg, params):
    """Three replicas behind a FleetRouter: streams equal one bare server's
    fault-free, under a replica killed mid-stream, under dispatch faults
    and under a failed replacement; the UIServer's routes answer."""
    from deeplearning4j_tpu_torch.ui import UIServer
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()    # earlier phases' cached blocks
    reqs = _requests(cfg) * 2
    cache_dir = OUT_DIR / "fleet-exec"
    shutil.rmtree(cache_dir, ignore_errors=True)
    cache_dir = str(cache_dir)
    ui = UIServer().start(port=0)
    try:
        arms, want = [], None
        for i, arm in enumerate(FLEET["arms"]):
            if arm == "single":
                out, run = _fleet_single(cfg, params, cache_dir, reqs)
            else:
                probe = ((lambda router: _fleet_probe(ui.port))
                         if i == 1 else None)
                run, out = _fleet_run(cfg, params, cache_dir, reqs,
                                      f"fault-free #{i}", during=probe)
                for k, st in enumerate(run["servers"]):
                    _fault_free(st, f"fleet: fault-free replica r{k}")
                if run["failed"] or run["shed"] or run["failovers"] \
                        or min(run["routed"]) < 1:
                    raise AssertionError(f"fleet: fault-free run: {run}")
                _fleet_stores_clean(run, "fault-free")
            if want is None:
                want = out
            _fleet_streams(f"{arm} arm {i}", out, want)
            arms.append(run)
        tps = {a: [r["tokens_per_s"] for r in arms if r.get("arm", "fleet")
                   == a] for a in ("single", "fleet")}
        ratio = float(np.median(tps["fleet"]) / np.median(tps["single"]))
        log(f"[fleet] tokens/s in turns single, fleet, fleet, single: "
            f"single {tps['single']}, fleet {tps['fleet']}; median fleet / "
            f"median single {ratio:.4f}; routed per replica "
            f"{[r['routed'] for r in arms if 'routed' in r]}")
        kill = _fleet_kill(cfg, params, cache_dir, reqs, want)
        plan = faults.FaultPlan(seed=22).every(faults.ROUTER_DISPATCH,
                                               FLEET["dispatch_every"])
        chaos, out = _fleet_run(cfg, params, cache_dir, reqs,
                                "dispatch chaos", plan=plan,
                                failover_budget=FLEET["failover_budget"])
        _fleet_streams("dispatch chaos", out, want)
        fired = chaos["fired"].get(faults.ROUTER_DISPATCH, 0)
        if not fired or chaos["failovers"] < fired or chaos["failed"]:
            raise AssertionError(f"fleet: dispatch chaos: {fired} faults, "
                                 f"{chaos['failovers']} failovers, "
                                 f"{chaos['failed']} failed")
        restart = _fleet_restart_fault(cfg, params, cache_dir, reqs, want,
                                       ui.port)
    finally:
        ui.stop()
    runs = arms + [kill, chaos, restart]
    launches = {k: sum(r["launches"][k] for r in runs)
                for k in ("flash_fwd", "flash_decode")}
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"fleet: kernels never launched: {missing}")
    seconds = time.perf_counter() - t_phase
    log(f"[fleet] launches over the phase {launches}; the phase "
        f"{seconds:.1f} s")
    drop = ("handles", "stamps", "events", "servers")
    for r in runs:
        for k in drop:
            r.pop(k, None)
    return {"arms": arms, "tokens_per_s": tps, "fleet_over_single": ratio,
            "kill": kill, "dispatch_chaos": chaos, "restart_fault": restart,
            "launches": launches, "seconds": seconds}


# -- phase 13: MultiLayerNetwork ---------------------------------------------
#: the mln phase: the LeNet MNIST drive, VGG16 at full width
#: (224×224×3, 1000 classes) trained at B=32 with the zoo's Nesterovs(1e-2,
#: 0.9) and dropout 0.5 on fc6/fc7, served by output() and through
#: ParallelInference's bucket ladder, and VGG16 as a chain ComputationGraph
MLN = dict(batch=32, warmup=2, steps=10, check_steps=3, seed=11,
           buckets=[1, 2, 4, 8, 16, 32], forwards=10, lenet_acc=0.85,
           lenet_epochs=3, maxnorm=1.0)
MLN_ARMS = ("eager", "graph", "graph", "eager")


def _lenet_conf(updater, accum=1, constraints=None):
    """LeNet (dl4j-examples' LenetMnistExample), in the reference's
    builder idiom."""
    b = (NeuralNetConfiguration.Builder().seed(123).updater(updater)
         .weightInit(WeightInit.XAVIER))
    if accum > 1:
        b = b.gradientAccumulation(accum)
    return (b.list()
            .layer(ConvolutionLayer.Builder(5, 5).stride(1, 1).nOut(20)
                   .activation(Activation.IDENTITY).build())
            .layer(SubsamplingLayer.Builder("max").kernelSize(2, 2)
                   .stride(2, 2).build())
            .layer(ConvolutionLayer.Builder(5, 5).stride(1, 1).nOut(50)
                   .activation(Activation.IDENTITY).build())
            .layer(SubsamplingLayer.Builder("max").kernelSize(2, 2)
                   .stride(2, 2).build())
            .layer(DenseLayer(nOut=500, activation="relu",
                              constraints=constraints))
            .layer(OutputLayer(lossFunction="negativeloglikelihood", nOut=10,
                               activation="softmax"))
            .setInputType(InputType.convolutionalFlat(28, 28, 1)).build())


def _mnist(batch=64, n=384):
    return MnistDataSetIterator(batch, num_examples=n)


def _unequal(a, b):
    """{what: tensors not bit-identical} of two networks' trees."""
    return {what: sum(not torch.equal(x, y) for x, y in zip(
        tensor_leaves(getattr(a, attr)), tensor_leaves(getattr(b, attr))))
        for what, attr in (("parameters", "_params"),
                           ("optimizer state", "_opt_state"),
                           ("BN state", "_state"))}


@contextlib.contextmanager
def _deterministic():
    """cuDNN's deterministic algorithms: its default weight-gradient
    convolutions sum in a varying order, so two eager steps already differ
    in the last bits."""
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = False


def _mln_lenet():
    """The LeNet MNIST drive on the card, then the schedule, the
    accumulation and the constraint through graphed fits, all under
    cuDNN's deterministic algorithms, so every gate reads one trajectory
    on every run."""
    with _deterministic():
        net = MultiLayerNetwork(_lenet_conf(Adam(1e-2))).init()
        net.fit(_mnist(), epochs=MLN["lenet_epochs"])
        acc = net.evaluate(MnistDataSetIterator(
            128, train=False, num_examples=256)).accuracy()
        st = net.fit_status()
        log(f"[mln] LeNet, Adam(1e-2), {MLN['lenet_epochs']} epochs of 384 "
            f"synthetic digits (graphed, prefetched): evaluate accuracy "
            f"{acc:.4f}; fit store {st['captures']} capture, "
            f"{st['replays']} replays, {st['degradations']} degradations")
        if not acc > MLN["lenet_acc"] or st["degradations"] or \
                st["captures"] != 1:
            raise AssertionError(f"mln: LeNet drive: accuracy {acc}, {st}")
        out = {"lenet_accuracy": acc}
        # stepsPerDispatch=3 against the sequential fit
        a = MultiLayerNetwork(_lenet_conf(Adam(1e-2))).init()
        b = MultiLayerNetwork(_lenet_conf(Adam(1e-2))).init()
        a.fit(_mnist(), epochs=2, stepsPerDispatch=3)
        b.fit(_mnist(), epochs=2)
        out["steps_per_dispatch_unequal"] = _unequal(a, b)
        ok = a.score() == b.score() and not any(
            out["steps_per_dispatch_unequal"].values())
        log(f"[mln] stepsPerDispatch=3 vs sequential, 12 steps: not "
            f"bit-identical {out['steps_per_dispatch_unequal']}; loss "
            f"{a.score()!r} vs {b.score()!r}")
        if not ok:
            raise AssertionError(f"mln: stepsPerDispatch: {out}")
        # a StepSchedule whose boundary (iteration 3) falls inside the fit
        nets = [MultiLayerNetwork(_lenet_conf(Nesterovs(
            StepSchedule(0.01, 0.5, 3), 0.9))).init() for _ in range(2)]
        nets[0].fit(_mnist())
        nets[1].fit(_mnist(), prefetch=0, cudaGraphs=False)
        sched = _unequal(*nets)
        st = nets[0].fit_status()
        log(f"[mln] StepSchedule(0.01, 0.5, 3), 6 steps graph vs eager: "
            f"not bit-identical {sched}; {st['replays']} replays")
        if any(sched.values()) or nets[0].score() != nets[1].score() \
                or st["replays"] != 5:
            raise AssertionError(f"mln: schedule: {sched}, {st}")
        out["schedule_unequal"] = sched
        # gradientAccumulation(4) against the explicit accumulation loop
        # (two updates of 4 batches: the eager first run and a replay)
        acc_net = MultiLayerNetwork(_lenet_conf(Nesterovs(0.01, 0.9),
                                                accum=4)).init()
        ref = acc_net.clone()
        batches = list(_mnist(64, 512))
        acc_net.fit(ListDataSetIterator(batches, 64))
        ref._build_optimizer()
        for g in range(0, len(batches), 4):
            gsum, lsum, state = None, None, ref._state
            for ds in batches[g:g + 4]:
                ins, labels, lm = ref._unpack(ds)
                loss, grads, state = ref._value_and_grad(ins, labels, lm,
                                                         state=state)
                gsum = grads if gsum is None else {
                    n: {k: gsum[n][k] + v for k, v in d.items()}
                    for n, d in grads.items()}
                lsum = loss if lsum is None else lsum + loss
            ref._update_in_place({n: {k: v * 0.25 for k, v in d.items()}
                                  for n, d in gsum.items()}, state)
        accum = _unequal(acc_net, ref)
        st = acc_net.fit_status()
        log(f"[mln] gradientAccumulation(4), two graphed updates vs the "
            f"explicit loop: not bit-identical {accum}; loss "
            f"{acc_net.score()!r} vs {float(lsum * 0.25)!r}; store "
            f"{st['keys']} key, {st['replays']} replay")
        if any(accum.values()) or acc_net.score() != float(lsum * 0.25) \
                or acc_net.getIterationCount() != 2 or st["replays"] != 1:
            raise AssertionError(f"mln: accumulation: {accum}, {st}")
        out["accumulation_unequal"] = accum
        # MaxNorm on the dense layer: the norms hold after every graphed step
        net = MultiLayerNetwork(_lenet_conf(Nesterovs(0.05, 0.9),
                                            constraints=[MaxNormConstraint(
                                                MLN["maxnorm"])])).init()
        worst = 0.0
        for ds in _mnist():
            net.fit(ds)
            worst = max(worst, float(torch.linalg.vector_norm(
                net._params["4"]["W"], dim=0).max()))
    log(f"[mln] MaxNorm({MLN['maxnorm']}) on the dense layer: largest unit "
        f"norm over 6 graphed steps {worst:.6f}")
    if not worst <= MLN["maxnorm"] * (1 + 1e-5) or \
            net.fit_status()["replays"] != 5:
        raise AssertionError(f"mln: MaxNorm: {worst}, {net.fit_status()}")
    out["maxnorm_worst"] = worst
    return out


def _vgg_batch():
    rng = np.random.default_rng(MLN["seed"])
    b = MLN["batch"]
    x = rng.random((b, 224, 224, 3), np.float32)
    y = np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, b)]
    return DataSet(x, y)


def _no_kernel_launched(what):
    """The MultiLayerNetwork path runs none of the nine kernels: VGG16's
    3×3 convs, pools and dense layers are cuDNN and cuBLAS calls."""
    launched = {k: n for k, n in _counts().items() if n}
    if launched:
        raise AssertionError(f"mln: {what} launched {launched}")


def _vgg_timed_arm(arm, m, ds):
    """One timed arm of VGG16 training: MLN["steps"] `fit` steps of `ds`,
    graphed or eager, with the peak memory it reached."""
    b, steps = MLN["batch"], MLN["steps"]
    it = ListDataSetIterator([ds] * steps, b)
    # the graph arm's activations live in its store's pool, allocated at
    # the capture: they are in `base`, not in the arm's rise
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    m.fit(it, cudaGraphs=arm == "graph")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _no_kernel_launched(f"VGG16 training ({arm})")
    peak = torch.cuda.max_memory_allocated()
    reads = None
    if arm == "graph":
        loss, reads = _score_reads(m, f"VGG16 fit {arm}")
    else:
        loss = m.score()
    log(f"[mln] VGG16 fit {arm}: {wall * 1e3 / steps:.2f} ms/step, "
        f"{b * steps / wall:.1f} images/s, loss {loss:.4f} at step "
        f"{m.getIterationCount()}, peak allocated {peak / 2**30:.3f} GiB "
        f"over {base / 2**30:.3f} GiB held before the arm (both nets, the "
        f"graph's pool)")
    if not np.isfinite(loss):
        raise AssertionError(f"mln: VGG16 fit {arm}: loss {loss}")
    return {"arm": arm, "ms_per_step": wall * 1e3 / steps,
            "images_per_s": b * steps / wall, "loss": loss,
            "iteration": m.getIterationCount(), "peak_bytes": peak,
            "base_bytes": base, "score_reads": reads}


def _score_syncs():
    """(count, summed blocked ms) of dl4j.pipeline.syncs{site="score"}."""
    snap = mon.get_registry().snapshot()
    n = sum(r["value"] for r in snap.get(mon.PIPELINE_SYNCS, [])
            if r["labels"].get("site") == "score")
    ms = sum(r["sum"] for r in snap.get(mon.PIPELINE_HOST_BLOCKED_MS, [])
             if r["labels"].get("site") == "score")
    return n, ms


def _all_syncs():
    snap = mon.get_registry().snapshot()
    return sum(r["value"] for r in snap.get(mon.PIPELINE_SYNCS, []))


@contextlib.contextmanager
def _monitoring_on():
    was = mon.enabled()
    mon.enable()
    try:
        yield
    finally:
        if not was:
            mon.disable()


def _score_reads(m, what):
    """The lazy score on the card: after a fit, the first score() is one
    counted sync on dl4j.pipeline.syncs{site="score"} and caches the float,
    so the second is none. Monitoring is on for the two reads only.
    Returns (the score, {"syncs": [first, second], "blocked_ms": the first
    read's})."""
    with _monitoring_on():
        n0, ms0 = _score_syncs()
        first = m.score()
        n1, ms1 = _score_syncs()
        second = m.score()
        n2, _ = _score_syncs()
    reads = {"syncs": [n1 - n0, n2 - n1], "blocked_ms": ms1 - ms0}
    log(f"[mln] {what}: score() syncs {reads['syncs']} (first read blocked "
        f"{reads['blocked_ms']:.4f} ms, after the arm's synchronize)")
    if reads["syncs"] != [1, 0] or second != first:
        raise AssertionError(f"mln: {what}: score reads {reads}, "
                             f"{first!r} then {second!r}")
    return first, reads


def _score_listener_syncs(m, ds, steps=10, every=5):
    """`steps` more graphed fit steps of `m` under ScoreIterationListener(
    every), monitoring on: the listener's reads are the only syncs, one
    each `every` iterations, each blocking on the steps still in flight."""
    b = MLN["batch"]
    it0 = m.getIterationCount()
    m.setListeners(ScoreIterationListener(every, log_fn=lambda *_: None))
    try:
        with _monitoring_on():
            n0, ms0 = _score_syncs()
            t0 = _all_syncs()
            m.fit(ListDataSetIterator([ds] * steps, b))
            torch.cuda.synchronize()
            n1, ms1 = _score_syncs()
            others = _all_syncs() - t0 - (n1 - n0)
    finally:
        m.setListeners()
    want = sum(1 for i in range(it0 + 1, it0 + steps + 1) if i % every == 0)
    out = {"steps": steps, "every": every, "syncs": n1 - n0,
           "expected": want, "other_syncs": others,
           "blocked_ms": ms1 - ms0}
    log(f"[mln] VGG16 {steps} more graphed steps under "
        f"ScoreIterationListener({every}): {out['syncs']} score syncs "
        f"(expected {want}), {others} other syncs; blocked "
        f"{out['blocked_ms']:.3f} ms in all")
    if out["syncs"] != want or want != steps // every or others:
        raise AssertionError(f"mln: ScoreIterationListener({every}) syncs: "
                             f"{out}")
    return out


def _mln_vgg_train():
    net = VGG16(updater=Nesterovs(1e-2, 0.9)).init()
    n_params = net.numParams()
    ds = _vgg_batch()
    b, n = MLN["batch"], MLN["check_steps"]
    with _deterministic():
        graph, eager = net.clone(), net.clone()
        graph.fit(ListDataSetIterator([ds] * n, b))
        eager.fit([ds] * n, prefetch=0, cudaGraphs=False)
        torch.cuda.synchronize()
        unequal = _unequal(graph, eager)
        scores = (graph.score(), eager.score())
        st = graph.fit_status()
    log(f"[mln] VGG16 fit B={b}, {n} steps, cuDNN deterministic: graph vs "
        f"eager not bit-identical {unequal}; loss {scores[0]!r} vs "
        f"{scores[1]!r}; graph store {st['captures']} capture, "
        f"{st['replays']} replays, {st['degradations']} degradations, "
        f"{st['eager_calls']} eager calls")
    if any(unequal.values()) or scores[0] != scores[1] or (
            st["captures"], st["replays"], st["degradations"],
            st["eager_calls"]) != (1, n - 1, 0, 0):
        raise AssertionError(f"mln: VGG16 graph vs eager: {unequal}, "
                             f"{scores}, {st}")
    del graph, eager
    torch.cuda.empty_cache()
    # The timed arms run under cuDNN's deterministic algorithms too:
    # Nesterovs(1e-2, 0.9) on one repeated batch of a VGG16 without BN is
    # at the edge of stability, and the default weight-gradient sums, whose
    # order varies from run to run, can send a trajectory to NaN within the
    # arms' 22 steps. Deterministic, both nets follow one trajectory on
    # every run, so arms at the same step give one loss.
    nets = {"eager": net.clone(), "graph": net.clone()}
    del net
    runs, steps = [], MLN["steps"]
    with _deterministic():
        for arm, m in nets.items():
            m.fit(ListDataSetIterator([ds] * MLN["warmup"], b),
                  cudaGraphs=arm == "graph")
        torch.cuda.synchronize()
        for arm in MLN_ARMS:
            runs.append(_vgg_timed_arm(arm, nets[arm], ds))
        listened = _score_listener_syncs(nets["graph"], ds)
    by_step = {}
    for run in runs:
        by_step.setdefault(run["iteration"], set()).add(run["loss"])
    if any(len(losses) != 1 for losses in by_step.values()):
        raise AssertionError(f"mln: VGG16 arms at one step disagree: {runs}")
    st = nets["graph"].fit_status()
    if (st["captures"], st["degradations"], st["eager_calls"]) != (1, 0, 0):
        raise AssertionError(f"mln: VGG16 graph store: {st}")
    del nets
    torch.cuda.empty_cache()
    return {"params": n_params, "bit_identity": {
        "steps": n, "unequal": unequal, "scores": scores},
        "runs": runs, "score_listener": listened, "store": {k: st[k] for k in (
            "captures", "replays", "degradations", "eager_calls")}}


def _mln_vgg_serve():
    net = VGG16().init()
    sizes, images = _resnet_requests()
    n_img = int(sum(sizes))
    x = torch.as_tensor(images[:MLN["batch"]], device=DEV)
    _reset_counts()
    mean_ms, min_ms = _forward_ms(net, x)
    _no_kernel_launched("VGG16 output()")
    log(f"[mln] VGG16 output() B={MLN['batch']}: {mean_ms:.3f} ms mean, "
        f"{min_ms:.3f} ms min (host clock, {RESNET['timed']} forwards)")
    want = np.concatenate([net.output(images[i:i + MLN["batch"]])
                           .cpu().numpy()
                           for i in range(0, n_img, MLN["batch"])])
    scale = float(np.abs(want).max())
    answers, lat, wall, launches, calls, info = _serve_resnet(
        net, images, sizes, ladder=MLN["buckets"])
    _no_kernel_launched("VGG16 serving")
    got = np.concatenate(answers)
    err = float(np.abs(got - want).max())
    st = info["status"]
    lat_ms = np.asarray(lat) * 1e3
    run = {"images": n_img, "requests": len(sizes), "wall_s": wall,
           "images_per_s": n_img / wall, "forwards": calls,
           "p50_ms": float(np.percentile(lat_ms, 50)),
           "p99_ms": float(np.percentile(lat_ms, 99)),
           "max_abs_err": err, "warmup": info["warmup"],
           "output_ms": mean_ms, "output_min_ms": min_ms}
    log(f"[mln] VGG16 ParallelInference bucketLadder({MLN['buckets']}): "
        f"{n_img} images in {len(sizes)} requests of 1-8 rows from "
        f"{RESNET['threads']} threads, {calls} forwards, {wall:.3f} s = "
        f"{n_img / wall:.1f} images/s; p50 {run['p50_ms']:.2f} ms p99 "
        f"{run['p99_ms']:.2f} ms; max |answer - output()| {err:.3e} of max "
        f"{scale:.3e}; warmup {info['warmup']}")
    if got.shape != (n_img, 1000) or not err <= RESNET_RTOL * scale:
        raise AssertionError(f"mln: VGG16 answers differ from output() by "
                             f"{err}")
    _store_clean(st["executables"], "mln VGG16 inference")
    if st["aot_fallbacks"] or info["warmup"]["captures"] != len(
            MLN["buckets"]):
        raise AssertionError(f"mln: VGG16 serving: {st}")
    del net
    torch.cuda.empty_cache()
    return run


def _chain_graph(conf):
    """A ComputationGraph of a MultiLayerConfiguration's layers as a chain,
    node i named "i", so its trees are keyed as the network's."""
    g = (NeuralNetConfiguration.Builder().seed(conf.seed)
         .updater(conf.defaults["updater"]).dataType(conf.data_type)
         .graphBuilder().addInputs("input").setInputTypes(conf.input_type))
    prev = "input"
    for i, layer in enumerate(conf.layers):
        g.addLayer(str(i), copy.deepcopy(layer), prev)
        prev = str(i)
    return ComputationGraph(g.setOutputs(prev).build())


def _mln_vs_graph():
    """VGG16 as a MultiLayerNetwork and as a chain ComputationGraph on the
    MultiLayerNetwork's parameters: one B=32 output and one training step
    (dropout drawn from each net's generator, seeded alike) bit for
    bit."""
    conf = VGG16(updater=Nesterovs(1e-2, 0.9)).conf()
    net = MultiLayerNetwork(conf).init()
    graph = graph_params_from_numpy(_chain_graph(conf),
                                    *multilayer_params_to_numpy(net))
    ds = _vgg_batch()
    out_equal = torch.equal(net.output(ds.features),
                            graph.output(ds.features))
    with _deterministic():
        net.fit(ds)
        graph.fit(ds)
        torch.cuda.synchronize()
    unequal = _unequal(net, graph)
    log(f"[mln] VGG16 MultiLayerNetwork vs chain ComputationGraph: "
        f"B={MLN['batch']} outputs bit-identical {out_equal}; after one "
        f"`fit` step not "
        f"bit-identical {unequal}; loss {net.score()!r} vs "
        f"{graph.score()!r}")
    if not out_equal or any(unequal.values()) or \
            net.score() != graph.score():
        raise AssertionError(f"mln: MultiLayerNetwork vs ComputationGraph: "
                             f"{out_equal}, {unequal}")
    del net, graph
    torch.cuda.empty_cache()
    return {"outputs_equal": out_equal, "step_unequal": unequal}


def _mln_vgg_profile():
    """--profile: VGG16's training step (3 steps, eager and graph) and one
    B=32 forward under torch.profiler (card busy and idle share, device
    time by kernel group)."""
    net = VGG16(updater=Nesterovs(1e-2, 0.9)).init()
    ds, b = _vgg_batch(), MLN["batch"]
    out = {}
    for arm in ("eager", "graph"):
        graph = arm == "graph"
        net.fit(ListDataSetIterator([ds] * 2, b), cudaGraphs=graph)
        torch.cuda.synchronize()
        it = ListDataSetIterator([ds] * 3, b)   # merged outside the window
        out[f"train {arm}"], _ = _profiled(
            f"VGG16 training B={b}, 3 steps {arm}",
            lambda: net.fit(it, cudaGraphs=graph))
    x = torch.as_tensor(ds.features, device=DEV)
    net.output(x)
    torch.cuda.synchronize()
    out["forward"], _ = _profiled(f"VGG16 forward B={b}",
                                  lambda: net.output(x))
    del net
    torch.cuda.empty_cache()
    return out


def phase_mln(profile=False):
    """MultiLayerNetwork on the card: the LeNet drive, VGG16 training and
    serving at full width, and VGG16 against its chain graph; with
    `profile`, VGG16's step and forward under torch.profiler."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    out = {"lenet": _mln_lenet(), "vgg16_train": _mln_vgg_train(),
           "vgg16_serve": _mln_vgg_serve(), "vs_graph": _mln_vs_graph()}
    if profile:
        out["profile"] = _mln_vgg_profile()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[mln] the phase {out['seconds']:.1f} s")
    return out


# -- phase 14 (--profile) -----------------------------------------------------
#: kernel-name substrings -> the part of a step they belong to
KERNEL_GROUPS = (("flash_fwd_kernel", "flash_fwd"),
                 ("flash_decode_kernel", "flash_decode"),
                 ("flash_bwd_dq_kernel", "flash_bwd_dq"),
                 ("flash_bwd_dkv_kernel", "flash_bwd_dkv"),
                 ("matmul_epilogue_kernel", "matmul_epilogue"),
                 ("bottleneck_block_kernel", "bottleneck_block"),
                 ("matmul_stats_kernel", "matmul_stats"),
                 ("bn_grad_stats_kernel", "bn_grad_stats"),
                 ("bn_conv_grads_kernel", "bn_conv_grads"),
                 ("bn_conv_grads_sum_kernel", "BN partial sums (rows 5/7/8)"),
                 ("sum_partials_kernel", "BN partial sums (rows 5/7/8)"),
                 ("layernorm_kernel", "fused_layernorm"),
                 ("nchwtonhwc", "layout (NHWC<->NCHW)"),
                 ("nhwctonchw", "layout (NHWC<->NCHW)"),
                 ("fprop", "conv (cuDNN)"), ("convolve", "conv (cuDNN)"),
                 ("conv2d", "conv (cuDNN)"), ("cudnn", "conv (cuDNN)"),
                 ("implicit_gemm", "conv (cuDNN)"), ("fft", "conv (cuDNN)"),
                 ("pointwise_mult_and_sum", "conv (cuDNN)"),
                 ("pool", "pooling"),
                 ("gemm", "matmul"), ("gemv", "matmul"),
                 ("cutlass", "matmul"), ("multi_tensor", "optimizer"),
                 ("sort", "sort (top-k)"), ("reduce", "reductions"),
                 ("index", "gather/scatter"), ("gather", "gather/scatter"),
                 ("direct_copy", "copies (incl. the page gather's)"),
                 ("elementwise", "elementwise"))


def _busy_us(spans):
    """Length of the union of [start, end) spans: the card's busy time."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


#: cycles of the two spin kernels that open a traced window: a long one
#: (~10 ms) while the profiler settles, then a short marker; only events
#: after the marker are read, since launches in a trace's first
#: milliseconds went unrecorded (a traced ResNet-50 forward showed 32 of
#: its 36 epilogue launches)
SETTLE_CYCLES, MARKER_CYCLES = 20_000_000, 1000


def _profiled(what, run, groups=KERNEL_GROUPS):
    """Run `run()` under torch.profiler: the card's busy and idle share of
    the wall time, and device time by kernel name, by category and by
    kernel group, decoded by the port's own trace reader
    (`optimize/xplane.py`: `op_table`, `category_rollup`). Returns (stats
    or None, what `run` returned). `groups`: (kernel-name substring,
    group) pairs, the first match naming a kernel's group. Only the card's
    activity is traced, and its raw events go to the decoder as Kineto's
    trace events without building the profiler's event tree: host
    operator events would slow the host loop that the idle share
    measures, and the tree takes longer to build than the run itself."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if torch._C._autograd._profiler_enabled():
        raise AssertionError(f"{what}: another torch.profiler window is "
                             "open (a ProfileSession's?)")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for cycles in (SETTLE_CYCLES, MARKER_CYCLES):
            torch.cuda._sleep(cycles)
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        ret = run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        t1 = time.perf_counter()
    # (name, start µs, duration µs, stream) of every kernel, copy and fill
    kern = [(e.name(), e.start_ns() / 1e3, e.duration_ns() / 1e3,
             getattr(e, "device_resource_id", lambda: 0)())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]
    marks = [s + dur for name, s, dur, _ in kern if "spin_kernel" in name]
    if marks:
        kern = [k for k in kern if k[1] >= max(marks)]
    else:
        log(f"[profile] {what}: the marker kernel was not recorded; every "
            "event is kept")
    log(f"[profile] {what}: {len(kern)} device events collected in "
        f"{time.perf_counter() - t1:.1f} s")
    if not kern:
        log(f"[profile] {what}: torch.profiler recorded no device kernels: "
            "device time not measured")
        return None, ret
    busy = _busy_us([(s, s + dur) for _, s, dur, _ in kern])
    events = [{"ph": "M", "name": "process_name", "pid": 0,
               "args": {"name": "GPU 0"}}]
    events += [{"ph": "X", "cat": "kernel", "name": name, "pid": 0,
                "tid": stream, "ts": start, "dur": dur}
               for name, start, dur, stream in kern]
    lines = [line for plane in xplane.planes_from_trace_events(
        events, with_stats=True, plane_substr="GPU")
        for line in plane["lines"]]
    rows = xplane.op_table(None, lines=lines)
    by_group = {}
    for r in rows:
        low = r["name"].lower()
        group = next((g for sub, g in groups if sub in low), "other")
        n, t = by_group.get(group, (0, 0.0))
        by_group[group] = (n + r["count"], t + r["self_ms"])
    out = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
           "idle_share": 1.0 - busy / wall_us, "kernels": len(kern),
           "groups": {g: {"count": n, "ms": t}
                      for g, (n, t) in sorted(by_group.items(),
                                              key=lambda kv: -kv[1][1])},
           "categories": xplane.category_rollup(rows),
           "top": [{"name": r["name"][:120], "count": r["count"],
                    "ms": r["self_ms"], "category": r["category"]}
                   for r in rows[:15]]}
    log(f"[profile] {what} under torch.profiler: wall {out['wall_ms']:.1f} "
        f"ms, card busy {out['device_busy_ms']:.1f} ms, idle share "
        f"{out['idle_share']:.4f}; {len(kern)} kernels")
    for g, d in out["groups"].items():
        log(f"[profile]   {g:<18} {d['count']:>7} kernels "
            f"{d['ms']:>10.3f} ms")
    for c in out["categories"]:
        log(f"[profile]   category {c['category']:<12} {c['count']:>7} "
            f"{c['self_ms']:>10.3f} ms {c['pct']:5.1f}%")
    return out, ret


def phase_profile(cfg, params, resnet_net, resnet_x, train_net, train_ds):
    """Under torch.profiler, eager and through its CUDA graphs: the serving
    phase's workload, one fused B=32 ResNet-50 forward and three fused
    ResNet-50 training steps; the paged phase's workload on the paged fp
    server through its graphs (where the page gather's time shows); and
    three fine-tune steps."""
    serving = {}
    for arm in ("eager", "graph", "paged graph"):
        paged = arm == "paged graph"
        reqs = _paged_requests(cfg, params) if paged else _requests(cfg)
        dkw = (dict(page_size=PAGED["page_size"],
                    pool_pages=PAGED["pool_pages"]) if paged else {})
        srv = GenerationServer(BertDecoder(cfg, params, **dkw),
                               cuda_graphs=arm != "eager", **SERVER)
        try:
            srv.warmup()
            torch.cuda.synchronize()
            prof, _ = _profiled(f"serving {arm}", lambda: [
                h.result(timeout=600)
                for h in [srv.submit(**r) for r in reqs]])
        finally:
            srv.shutdown()
        st = srv.status()
        _fault_free(st, f"profile: serving {arm}")
        if prof is not None:
            steps = st["steps"] * srv.superstep
            ex = st["executables"]
            prof.update(decode_steps=steps, admissions=st["admissions"],
                        kernels_per_decode_step=prof["kernels"] / steps,
                        graph_replays=ex["replays"])
            log(f"[profile] serving {arm}: {steps} decode steps + "
                f"{st['admissions']} prefills "
                f"({prof['kernels_per_decode_step']:.1f} kernels per decode "
                f"step; {ex['replays']} graph replays)")
        serving[arm] = prof
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    step = _trainer(cfg, params, _train_batch(cfg), gen)
    step()
    torch.cuda.synchronize()
    train, _ = _profiled("train (3 steps)",
                         lambda: [step() for _ in range(3)])
    if train is not None:
        train["steps"] = 3
    del step
    store = ExecutableStore(resnet_net)
    sig = ((tuple(resnet_x.shape), "float32"),)
    store.warmup([sig])
    (static,) = store.ensure(sig)

    def replay():
        static.copy_(resnet_x)
        return store.run(("forward", sig))

    resnet = {}
    for arm, fn in (("eager", lambda: resnet_net.output(resnet_x)),
                    ("graph", replay)):
        fn()
        torch.cuda.synchronize()
        resnet[arm], _ = _profiled(f"resnet fused forward B=32 {arm}", fn)
    del store, static
    resnet_train = {}
    for arm, prefetch in (("eager", 0), ("graph", 0), ("graph", 2)):
        graph = arm == "graph"
        train_net.fit(train_ds, cudaGraphs=graph)
        torch.cuda.synchronize()
        name = f"{arm} prefetch {prefetch}"
        resnet_train[name], _ = _profiled(
            f"resnet fused training B=32, 3 steps {name}",
            lambda: train_net.fit(
                ListDataSetIterator([train_ds] * 3, RESNET_TRAIN["batch"]),
                cudaGraphs=graph, prefetch=prefetch))
        if resnet_train[name] is not None:
            resnet_train[name]["steps"] = 3
    return {"serving": serving, "train": train, "resnet": resnet,
            "resnet_train": resnet_train}


# -- phase 15: recurrent and attention networks ---------------------------------
#: TextGenerationLSTM at the zoo's width (77 classes, LSTM(256) × 2), trained
#: as dl4j-examples' GravesLSTMCharModellingExample: B=32, 1000-character
#: sequences, truncated BPTT 50/50; served with the zoo docstring's
#: settings (8 slots, rung 512, top-k 5); 24 requests, prompts 5-120
#: characters, 64-200 new tokens, greedy and top-k in turn
RNN = dict(classes=77, width=256, batch=32, seq=1000, tbptt=50,
           check_seq=120, warmup_batches=1, requests=24, prompt=(5, 121),
           new=(64, 201), slots=8, rung=512, top_k=5, seed=13,
           length_buckets=[16, 64, 128], length_ladder=[1, 2, 4, 8],
           length_requests=12)
#: the attention stack of examples/attention_sequence_classifier.py and its
#: gate; the wide SelfAttentionLayer at real shape (D = 64), and again at
#: DL4J's default single head (D = 512: the heads phase)
ATTN = dict(t=24, f=8, train=256, test=64, epochs=30, acc=0.8,
            wide=dict(b=16, t=512, width=512, heads=8),
            one_head=dict(b=16, t=512, width=512, heads=1), wide_rtol=1e-4)
#: eager vs graph answers of one net, and lengthBuckets' answers against
#: output(): the same operations at other batch row counts, which cuBLAS
#: may sum in another order (f32)
RNN_RTOL = 1e-5
RNN_ARMS = ("eager", "graph", "graph", "eager")


def _char_corpus(n, seed):
    """n characters of a seeded synthetic text over 77 symbols: words of
    2-8 letters drawn from a 400-word lexicon (Zipf-weighted), separated
    by symbol 0, with symbol 1 closing a sentence every 5-15 words."""
    rng = np.random.default_rng(seed)
    c = RNN["classes"]
    lexicon = [rng.integers(2, c, int(rng.integers(2, 9)))
               for _ in range(400)]
    weights = 1.0 / np.arange(1, 401)
    words = rng.choice(400, size=n // 2, p=weights / weights.sum())
    ends = set(np.cumsum(rng.integers(5, 16, n // 2)).tolist())
    out, size = [], 0
    for i, w in enumerate(words):
        if size >= n:
            break
        if i in ends:
            out.append(np.array([1]))
        out += [lexicon[w], np.array([0])]
        size += len(lexicon[w]) + 1 + (i in ends)
    return np.concatenate(out)[:n]


def _char_batches(corpus, b, t, count, offset=0):
    """`count` DataSets of B sequences of t characters: features one-hot
    of each character, labels one-hot of the next."""
    eye = np.eye(RNN["classes"], dtype=np.float32)
    out = []
    for i in range(count):
        starts = offset + (i * b + np.arange(b)) * (t + 1)
        idx = starts[:, None] + np.arange(t + 1)[None, :]
        chars = corpus[idx]
        out.append(DataSet(eye[chars[:, :-1]], eye[chars[:, 1:]]))
    return out


def _text_lstm():
    conf = TextGenerationLSTM(numClasses=RNN["classes"],
                              lstmLayerSize=RNN["width"]).conf()
    conf.backprop_type = BackpropType.TruncatedBPTT
    conf.tbptt_fwd_length = conf.tbptt_back_length = RNN["tbptt"]
    return MultiLayerNetwork(conf).init()


def _rnn_train(corpus):
    """TBPTT training of TextGenerationLSTM: graph against eager bit for
    bit on a B=32, T=120 batch (two full segments and a short one: two
    segment signatures, two captures), then timed arms of one B=32,
    T=1000 batch (20 segments) each, eager and graph in turns."""
    b, t, seg = RNN["batch"], RNN["seq"], RNN["tbptt"]
    net = _text_lstm()
    n_params = net.numParams()
    check = _char_batches(corpus, b, RNN["check_seq"], 1)[0]
    with _deterministic():
        graph, eager = net.clone(), net.clone()
        _reset_counts()
        graph.fit(check)
        eager.fit(check, cudaGraphs=False)
        torch.cuda.synchronize()
        unequal = _unequal(graph, eager)
        scores = (graph.score(), eager.score())
        st = graph.fit_status()
    n_seg = -(-RNN["check_seq"] // seg)
    log(f"[rnn] TextGenerationLSTM ({n_params} parameters) TBPTT {seg}, "
        f"B={b} T={RNN['check_seq']} ({n_seg} segments), cuDNN "
        f"deterministic: graph vs eager not bit-identical {unequal}; loss "
        f"{scores[0]!r} vs {scores[1]!r}; graph store {st['captures']} "
        f"captures (one per segment signature), {st['replays']} replays, "
        f"{st['degradations']} degradations, {st['eager_calls']} eager "
        f"calls")
    if any(unequal.values()) or scores[0] != scores[1] or (
            st["captures"], st["replays"], st["degradations"],
            st["eager_calls"]) != (2, n_seg - 2, 0, 0):
        raise AssertionError(f"rnn: TBPTT graph vs eager: {unequal}, "
                             f"{scores}, {st}")
    _no_kernel_launched("TextGenerationLSTM training")
    del graph, eager
    nets = {"eager": net.clone(), "graph": net.clone()}
    del net
    batches = _char_batches(corpus, b, t, RNN["warmup_batches"]
                            + len(RNN_ARMS) // 2,
                            offset=b * (RNN["check_seq"] + 1))
    with _deterministic():
        for arm, m in nets.items():
            m.fit(batches[0], cudaGraphs=arm == "graph")
        torch.cuda.synchronize()
        runs, used = [], {"eager": 1, "graph": 1}
        for arm in RNN_ARMS:
            ds = batches[used[arm]]
            used[arm] += 1
            _reset_counts()
            t0 = time.perf_counter()
            nets[arm].fit(ds, cudaGraphs=arm == "graph")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            _no_kernel_launched(f"TextGenerationLSTM training ({arm})")
            loss = nets[arm].score()
            segs = t // seg
            run = {"arm": arm, "segments": segs, "wall_s": wall,
                   "segments_per_s": segs / wall,
                   "chars_per_s": b * t / wall, "loss": loss,
                   "iteration": nets[arm].getIterationCount()}
            log(f"[rnn] TextGenerationLSTM fit {arm}: one B={b} T={t} "
                f"batch = {segs} segments in {wall * 1e3:.1f} ms: "
                f"{segs / wall:.1f} segments/s, {b * t / wall:.0f} "
                f"characters/s, mean segment loss {loss:.4f} at batch "
                f"{run['iteration']}")
            if not np.isfinite(loss):
                raise AssertionError(f"rnn: TBPTT {arm}: loss {loss}")
            runs.append(run)
    by_batch = {}
    for run in runs:
        by_batch.setdefault(run["iteration"], set()).add(run["loss"])
    st = nets["graph"].fit_status()
    if any(len(v) != 1 for v in by_batch.values()) or (
            st["captures"], st["degradations"], st["eager_calls"]) != (
                1, 0, 0):
        raise AssertionError(f"rnn: TBPTT arms: {runs}, {st}")
    eager_ms = [r["wall_s"] for r in runs if r["arm"] == "eager"]
    graph_ms = [r["wall_s"] for r in runs if r["arm"] == "graph"]
    log(f"[rnn] TBPTT graph over eager wall: "
        f"{np.median(graph_ms) / np.median(eager_ms):.4f}; both arms read "
        f"one loss at each batch; graph store {st['captures']} capture, "
        f"{st['replays']} replays")
    del nets["eager"]
    torch.cuda.empty_cache()
    return nets["graph"], {"params": n_params, "bit_identity": {
        "segments": n_seg, "unequal": unequal, "scores": scores},
        "runs": runs, "store": {k: st[k] for k in (
            "captures", "replays", "degradations", "eager_calls")}}


def _rnn_requests(corpus):
    rng = np.random.default_rng(RNN["seed"] + 1)
    reqs = []
    for i in range(RNN["requests"]):
        plen = int(rng.integers(*RNN["prompt"]))
        start = int(rng.integers(0, len(corpus) - plen))
        greedy = i % 2 == 0
        reqs.append(dict(prompt=corpus[start:start + plen],
                         max_new_tokens=int(rng.integers(*RNN["new"])),
                         method="greedy" if greedy else "top_k",
                         top_k=0 if greedy else RNN["top_k"]))
    return reqs


@torch.no_grad()
def _step_loop(net, prompt, n):
    """The greedy continuation of `prompt` by an `rnnTimeStep` loop of
    the network: (tokens, the smallest top-2 gap of the log-probabilities
    along them, which is the logits' gap)."""
    eye = torch.eye(RNN["classes"], device=DEV)
    net.rnnClearPreviousState()
    probs = net.rnnTimeStep(eye[torch.as_tensor(prompt, device=DEV)][None])
    probs = probs[0, -1]
    toks, gap = [], float("inf")
    for _ in range(n):
        top = torch.topk(torch.log(probs), 2).values
        gap = min(gap, float(top[0] - top[1]))
        tok = int(probs.argmax())
        toks.append(tok)
        probs = net.rnnTimeStep(eye[[tok]])[0]
    net.rnnClearPreviousState()
    return toks, gap


def _rnn_serve(net, corpus):
    """TextGenerationLSTM served with the docstring's settings, graph then
    eager: every stream equal across the arms, the greedy ones equal to
    an rnnTimeStep loop of the net; no capture after the warm-up."""
    reqs = _rnn_requests(corpus)
    runs = {}
    for arm in ("graph", "eager"):
        srv = TextGenerationLSTM(numClasses=RNN["classes"]).generationServer(
            net, slots=RNN["slots"], cache_lengths=[RNN["rung"]],
            method="top_k", top_k=RNN["top_k"], seed=RNN["seed"],
            cuda_graphs=arm == "graph")
        try:
            warm = srv.warmup()
            torch.cuda.synchronize()
            _reset_counts()
            t0 = time.perf_counter()
            streams = [h.result(timeout=600)
                       for h in [srv.submit(**r) for r in reqs]]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            srv.shutdown()
        st = srv.status()
        _fault_free(st, f"rnn: serving {arm}")
        _no_kernel_launched(f"TextGenerationLSTM serving ({arm})")
        ex = st["executables"]
        ntok = sum(len(s) for s in streams)
        runs[arm] = {"tokens": ntok, "wall_s": wall,
                     "tokens_per_s": ntok / wall,
                     "per_token_p50_ms": st["per_token_p50_ms"],
                     "per_token_p99_ms": st["per_token_p99_ms"],
                     "blocks": st["steps"], "admissions": st["admissions"],
                     "keys": sorted(map(str, srv.executable_keys())),
                     "warmup": warm, "replays": ex["replays"],
                     "eager_calls": ex["eager_calls"], "streams": streams}
        log(f"[rnn] TextGenerationLSTM serving {arm} (slots "
            f"{RNN['slots']}, rung {st['cache_lengths']}, top-k "
            f"{RNN['top_k']}): {len(reqs)} requests, {ntok} tokens in "
            f"{wall:.3f} s = {ntok / wall:.1f} tokens/s; per-token p50 "
            f"{st['per_token_p50_ms']:.3f} ms p99 "
            f"{st['per_token_p99_ms']:.3f} ms; {st['steps']} blocks, "
            f"{st['admissions']} admissions; {len(srv.executable_keys())} "
            f"keys; {ex['replays']} replays, {ex['eager_calls']} eager "
            f"calls")
        if st["cache_lengths"] != [RNN["rung"]] or any(
                len(s) != r["max_new_tokens"] for s, r in zip(streams,
                                                             reqs)):
            raise AssertionError(f"rnn: serving {arm}: {st}")
        if arm == "graph":
            _store_clean(ex, "rnn serving")
    if runs["graph"]["streams"] != runs["eager"]["streams"]:
        raise AssertionError("rnn: graph and eager servers' streams differ")
    greedy = [i for i, r in enumerate(reqs) if r["method"] == "greedy"]
    gaps, diff = [], []
    for i in greedy:
        want, gap = _step_loop(net, reqs[i]["prompt"],
                               reqs[i]["max_new_tokens"])
        gaps.append(gap)
        if runs["graph"]["streams"][i] != want:
            diff.append(i)
    # decode at 8 slots against the one-row step loop, on one request
    dec = RecurrentDecoder(net)
    margs, cache = dec.model_args(), dec.init_cache(RNN["slots"], RNN["rung"])
    r0, slot = reqs[greedy[0]], RNN["slots"] - 1
    prompt = torch.as_tensor(r0["prompt"], device=DEV)
    padded = torch.zeros(128, dtype=torch.long, device=DEV)
    padded[:len(prompt)] = prompt
    with torch.no_grad():
        cache, logits = dec.prefill(margs, cache,
                                    torch.tensor(slot, device=DEV), padded,
                                    torch.tensor(len(prompt), device=DEV))
        eye = torch.eye(RNN["classes"], device=DEV)
        _, pre, _, _, carries = net._forward(
            net._params, net._state, eye[prompt][None], False, carries={})
        worst = float((logits - pre[0, -1]).abs().max())
        tok = int(logits.argmax())
        for _ in range(16):
            tokens = torch.zeros(RNN["slots"], dtype=torch.long, device=DEV)
            tokens[slot] = tok
            logits, cache = dec.step(margs, cache, tokens,
                                     torch.zeros_like(tokens))
            _, pre, _, _, carries = net._forward(
                net._params, net._state, eye[[tok]][None], False,
                carries=carries)
            worst = max(worst,
                        float((logits[slot] - pre[0, -1]).abs().max()))
            tok = int(logits[slot].argmax())
    log(f"[rnn] greedy streams equal to the rnnTimeStep loop "
        f"{len(greedy) - len(diff)}/{len(greedy)}; smallest top-2 logit gap "
        f"along them {min(gaps):.4e}; largest |Δlogit| of 8-slot decode "
        f"(prefill + 16 steps) against the one-row step loop {worst:.3e}; "
        f"graph and eager streams equal (greedy and top-k)")
    if diff:
        raise AssertionError(f"rnn: greedy streams {diff} differ from the "
                             f"rnnTimeStep loop (smallest gap {min(gaps)})")
    for run in runs.values():
        del run["streams"]
    return {"runs": runs, "greedy": len(greedy), "min_top2_gap": min(gaps),
            "decode_vs_step_max_abs_logit": worst}


def _rnn_length_buckets(net, corpus):
    """ParallelInference over the LSTM net with a batch ladder and a length
    ladder: requests of 5-120 characters from 4 threads coalesce under a
    mask; every answer equals `output()` on its unpadded input."""
    rng = np.random.default_rng(RNN["seed"] + 2)
    eye = np.eye(RNN["classes"], dtype=np.float32)
    xs = []
    for _ in range(RNN["length_requests"]):
        n, t = int(rng.integers(1, 3)), int(rng.integers(5, 121))
        starts = rng.integers(0, len(corpus) - t, n)
        xs.append(eye[corpus[starts[:, None] + np.arange(t)[None, :]]])
    pi = (ParallelInference.Builder(net)
          .inferenceMode(InferenceMode.BATCHED)
          .bucketLadder(RNN["length_ladder"])
          .lengthBuckets(RNN["length_buckets"]).build())
    got = [None] * len(xs)
    try:
        warm = pi.warmup()
        torch.cuda.synchronize()

        def call(i):
            got[i] = pi.output(xs[i])

        t0 = time.perf_counter()
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(xs))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        st = pi.status()
    finally:
        pi.shutdown()
    worst = 0.0
    for x, y in zip(xs, got):
        want = net.output(x).cpu().numpy()
        worst = max(worst, float(np.abs(y - want).max()))
    log(f"[rnn] lengthBuckets({RNN['length_buckets']}) over "
        f"bucketLadder({RNN['length_ladder']}): {len(xs)} requests of 5-120 "
        f"characters in {st['model_calls']} forwards, {wall:.3f} s; max "
        f"|answer - output()| {worst:.3e}; warmup {warm}")
    _store_clean(st["executables"], "rnn lengthBuckets")
    if not worst <= RNN_RTOL or st["aot_fallbacks"] or \
            warm["captures"] != len(RNN["length_buckets"]) * len(
                RNN["length_ladder"]):
        raise AssertionError(f"rnn: lengthBuckets: {worst}, {st}")
    return {"requests": len(xs), "forwards": st["model_calls"],
            "wall_s": wall, "max_abs_err": worst, "warmup": warm}


def _attention_data(n, seed):
    """examples/attention_sequence_classifier.py's task: does the ragged
    sequence hold a spike > 2?"""
    t, f = ATTN["t"], ATTN["f"]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, t, f)).astype(np.float32) * 0.5
    lengths = rng.integers(8, t + 1, n)
    mask = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
    labels = rng.integers(0, 2, n)
    for i in np.where(labels == 1)[0]:
        x[i, rng.integers(0, lengths[i])] += 3.0
    x *= mask[:, :, None]
    ds = DataSet(x, np.eye(2, dtype=np.float32)[labels])
    ds.featuresMask = mask
    return ds


def _attention_net():
    conf = (NeuralNetConfiguration.Builder()
            .seed(7).updater(Adam(3e-3)).weightInit("xavier")
            .list()
            .layer(SelfAttentionLayer(nOut=32, nHeads=4))
            .layer(LearnedSelfAttentionLayer(nOut=32, nHeads=4, nQueries=4))
            .layer(LastTimeStep(LSTM(nOut=16)))
            .layer(OutputLayer(lossFunction="mcxent", nOut=2,
                               activation="softmax"))
            .setInputType(InputType.recurrent(ATTN["f"], ATTN["t"]))
            .build())
    return MultiLayerNetwork(conf).init()


def _attention_train():
    """The example's stack trained on the card, graphed and eagerly from
    one init: both reach the example's accuracy gate, flash_fwd,
    flash_bwd_dq and flash_bwd_dkv launch inside the graphed step, and
    the two nets' masked outputs agree."""
    train = _attention_data(ATTN["train"], 0)
    test = _attention_data(ATTN["test"], 1)
    net = _attention_net()
    out = {}
    with _deterministic():
        graph, eager = net.clone(), net.clone()
        for arm, m in (("graph", graph), ("eager", eager)):
            _reset_counts()
            t0 = time.perf_counter()
            for _ in range(ATTN["epochs"]):
                m.fit(train, cudaGraphs=arm == "graph")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: v for k, v in _counts().items() if v}
            preds = m.output(test.features, fmask=test.featuresMask)
            acc = float((preds.argmax(-1).cpu().numpy()
                         == test.labels.argmax(-1)).mean())
            out[arm] = {"accuracy": acc, "wall_s": wall,
                        "ms_per_step": wall * 1e3 / ATTN["epochs"],
                        "launches": launches, "loss": m.score()}
            log(f"[rnn] attention stack fit {arm}: {ATTN['epochs']} steps "
                f"of B={ATTN['train']} T={ATTN['t']} (D = 8, padded to 16 "
                f"in the kernels) in {wall:.3f} s ({wall * 1e3 / ATTN['epochs']:.2f}"
                f" ms/step); test accuracy {acc:.4f}; launches {launches}")
            if not acc > ATTN["acc"]:
                raise AssertionError(f"rnn: attention {arm}: accuracy {acc}")
            missing = [k for k in ("flash_fwd", "flash_bwd_dq",
                                   "flash_bwd_dkv") if not launches.get(k)]
            if missing:
                raise AssertionError(f"rnn: attention {arm}: never "
                                     f"launched {missing}")
        st = graph.fit_status()
        a = graph.output(test.features, fmask=test.featuresMask)
        b = eager.output(test.features, fmask=test.featuresMask)
        err = float((a - b).abs().max())
    log(f"[rnn] attention stack graph vs eager: max |output(fmask=)| "
        f"difference {err:.3e}; graph store {st['captures']} capture, "
        f"{st['replays']} replays, {st['degradations']} degradations, "
        f"{st['eager_calls']} eager calls")
    if not err <= RNN_RTOL or (st["captures"], st["degradations"],
                               st["eager_calls"]) != (1, 0, 0):
        raise AssertionError(f"rnn: attention graph vs eager: {err}, {st}")
    out.update(graph_vs_eager_max_abs=err, store={k: st[k] for k in (
        "captures", "replays", "degradations", "eager_calls")})
    del net, graph, eager
    torch.cuda.empty_cache()
    return out


def _sdpa_attend(q, k, v, mask):
    """The library yardstick of self-attention's `_attend`: SDPA under the
    key mask, padded query rows zeroed (every example here has a valid
    key)."""
    m = mask.bool()
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=m[:, None, None])
    return torch.where(m[:, None, :, None], o, 0)


def _plain_attend(q, k, v, mask):
    """Self-attention's `_attend` through the kernels' plain version."""
    m = mask.bool()
    o, _ = _flash_forward_reference(q, k, v, m, False)
    return torch.where(m[:, None, :, None], o, 0)


def _attention_wide(w=None, tag="rnn"):
    """A SelfAttentionLayer at nIn = nOut = 512, 8 heads (D = 64; or the
    knobs `w`, ATTN["wide"]'s by default), B=16, T=512, ragged masks,
    forward and backward: the layer through the kernels against the layer
    through their plain versions (outputs and every gradient within
    ATTN["wide_rtol"] of the largest), the kernels against their plain
    versions on the layer's own q, k, v and output cotangent (the kernel
    rows' gates), and the layer's ms against the same layer on SDPA."""
    w = w or ATTN["wide"]
    b, t, width, heads = w["b"], w["t"], w["width"], w["heads"]
    layer = SelfAttentionLayer(nIn=width, nOut=width, nHeads=heads)
    layer.apply_defaults({})
    gen = torch.Generator().manual_seed(3)
    params, _, _ = layer.initialize(gen, InputType.recurrent(width, t))
    params = {k: v.to(DEV).requires_grad_() for k, v in params.items()}
    g = torch.Generator(device=DEV).manual_seed(5)
    x = torch.randn((b, t, width), generator=g, device=DEV).requires_grad_()
    lens = torch.linspace(t, 1, b, device=DEV).round().long()
    mask = (torch.arange(t, device=DEV)[None] < lens[:, None]).float()
    dy = torch.randn((b, t, width), generator=g, device=DEV)
    leaves = [x] + list(params.values())

    def fwd_bwd(attend):
        real = attn_conf._attend
        attn_conf._attend = attend
        try:
            y, _ = layer.apply(params, {}, x, mask=mask)
            grads = torch.autograd.grad(y, leaves, dy)
        finally:
            attn_conf._attend = real
        return y, grads

    _reset_counts()
    y, grads = fwd_bwd(attn_conf._attend)
    torch.cuda.synchronize()
    launches = {k: v for k, v in _counts().items() if v}
    yp, gp = fwd_bwd(_plain_attend)
    errs = [float((a - c).abs().max()) / max(1.0, float(c.abs().max()))
            for a, c in zip((y.detach(),) + grads, (yp.detach(),) + gp)]
    ms = time_ms(lambda: fwd_bwd(attn_conf._attend), iters=5)
    lib = time_ms(lambda: fwd_bwd(_sdpa_attend), iters=5)
    plain = time_ms(lambda: fwd_bwd(_plain_attend), iters=5)
    # the kernels on the layer's own operands
    with torch.no_grad():
        q, k, v = (attn_conf._split_heads(x @ params[n], heads)
                   .contiguous() for n in ("Wq", "Wk", "Wv"))
    gen_k = torch.Generator(device=DEV).manual_seed(6)
    m = mask.bool()
    o, lse = flash_fwd(q, k, v, m, False)
    ref, ref_lse = _flash_forward_reference(q, k, v, m, False)
    fwd_err = max(float((o - ref).abs().max()), float(
        (lse - ref_lse).abs().max()))
    go = torch.randn(q.shape, generator=gen_k, device=DEV)
    o2, lse2 = _flash_forward(q, k, v, m, m, False)
    args = (q, k, v, go, lse2, _delta(go, o2), m, False)
    bwd_errs = []
    for kernel, plain_fn in ((flash_bwd_dq, _dq_reference),
                             (flash_bwd_dkv, _dkv_reference)):
        got, want = _as_tuple(kernel(*args)), _as_tuple(plain_fn(*args))
        scale = max([1.0] + [float(c.abs().max()) for c in want])
        bwd_errs.append(max(float((a - c).abs().max()) for a, c in
                            zip(got, want)) / scale)
    log(f"[{tag}] wide SelfAttentionLayer nIn=nOut={width}, {heads} heads "
        f"(D = {width // heads}), B={b} T={t}, ragged masks: forward + "
        f"backward {ms:.3f} ms through the kernels, {lib:.3f} ms on SDPA, "
        f"{plain:.3f} ms on the plain versions; layer vs plain (relative to "
        f"the largest) output {errs[0]:.3e}, gradients "
        f"{max(errs[1:]):.3e}; kernels on the layer's operands: flash_fwd "
        f"{fwd_err:.3e} (atol {ATOL[torch.float32]:.0e}), dq "
        f"{bwd_errs[0]:.3e}, dk/dv {bwd_errs[1]:.3e} (relative, atol "
        f"{ATOL[torch.float32]:.0e}); launches {launches}")
    if max(errs) > ATTN["wide_rtol"] or fwd_err > ATOL[torch.float32] or \
            max(bwd_errs) > ATOL[torch.float32]:
        raise AssertionError(f"{tag}: wide attention: {errs}, {fwd_err}, "
                             f"{bwd_errs}")
    missing = [k for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
               if not launches.get(k)]
    if missing:
        raise AssertionError(f"{tag}: wide attention never launched "
                             f"{missing}")
    return {"shape": [b, heads, t, width // heads], "ms": ms,
            "sdpa_ms": lib, "plain_ms": plain, "layer_rel_err": errs,
            "fwd_err": fwd_err, "bwd_rel_err": bwd_errs,
            "launches": launches}


def _rnn_profile(net, corpus):
    """--profile: one B=32, T=1000 TBPTT batch eager and graphed, and the
    serving workload on the graphed server, under torch.profiler (card
    busy and idle share, device time by kernel group)."""
    ds = _char_batches(corpus, RNN["batch"], RNN["seq"], 1)[0]
    out = {}
    for arm in ("eager", "graph"):
        out[f"tbptt {arm}"], _ = _profiled(
            f"TextGenerationLSTM TBPTT, one B={RNN['batch']} T={RNN['seq']} "
            f"batch {arm}", lambda: net.fit(ds, cudaGraphs=arm == "graph"))
    reqs = _rnn_requests(corpus)
    srv = TextGenerationLSTM(numClasses=RNN["classes"]).generationServer(
        net, slots=RNN["slots"], cache_lengths=[RNN["rung"]],
        method="top_k", top_k=RNN["top_k"], seed=RNN["seed"])
    try:
        srv.warmup()
        torch.cuda.synchronize()
        out["serving graph"], _ = _profiled(
            "TextGenerationLSTM serving graph", lambda: [
                h.result(timeout=600)
                for h in [srv.submit(**r) for r in reqs]])
    finally:
        srv.shutdown()
    return out


def phase_rnn(profile=False):
    """Recurrent and attention networks on the card: TextGenerationLSTM
    trained with truncated BPTT and served, lengthBuckets over it, the
    example's attention stack trained through the flash kernels, and the
    wide SelfAttentionLayer at real shape. The counts are set to 0 before
    each path and read after it: the LSTM paths launch none of the nine
    kernels, the attention paths flash_fwd, flash_bwd_dq and
    flash_bwd_dkv. With `profile`, the TBPTT batch and the serving
    workload under torch.profiler."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    b = RNN["batch"]
    corpus = _char_corpus(b * (RNN["check_seq"] + 1) + b * (RNN["seq"] + 1)
                          * (RNN["warmup_batches"] + len(RNN_ARMS) // 2),
                          RNN["seed"])
    net, train = _rnn_train(corpus)
    out = {"train": train, "serve": _rnn_serve(net, corpus)}
    out["length_buckets"] = _rnn_length_buckets(net, corpus)
    if profile:
        out["profile"] = _rnn_profile(net, corpus)
    del net
    torch.cuda.empty_cache()
    _reset_counts()
    out["attention"] = _attention_train()
    out["attention_wide"] = _attention_wide()
    out["launches"] = {k: out["attention"]["graph"]["launches"].get(k, 0)
                       for k in ("flash_fwd", "flash_bwd_dq",
                                 "flash_bwd_dkv")}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[rnn] the phase {out['seconds']:.1f} s")
    return out


# -- phase 15b: heads ----------------------------------------------------------
#: DL4J's default single head at full width: the stack of
#: examples/attention_sequence_classifier.py (SelfAttentionLayer ->
#: LearnedSelfAttentionLayer(nQueries=4) -> LastTimeStep(LSTM(16)) ->
#: OutputLayer) as a MultiLayerNetwork at nIn = nOut = 256, one head (D =
#: 256 in both attention layers; the learned one cross-attends, Tq = 4),
#: B = 32, T = 512, ragged masks, Adam; 2 warm-up and 10 timed fit steps,
#: the graphed and the eager net in turns. Serving at D = 256 (BERT-base
#: width, 3 heads; depth cut to `base_layers` of its 12) and at bert_tiny's
#: D = 8 (cache rows up to 512; dense, and paged at the paged phase's
#: pool), over serving's knobs and 12 requests.
HEADS = dict(width=256, batch=32, seq=512, queries=4, lr=1e-3, warmup=2,
             steps=10, seed=19, base_layers=4)
HEADS_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def _one_head_net():
    w = HEADS["width"]
    conf = (NeuralNetConfiguration.Builder()
            .seed(HEADS["seed"]).updater(Adam(HEADS["lr"]))
            .weightInit("xavier")
            .list()
            .layer(SelfAttentionLayer(nOut=w, nHeads=1))
            .layer(LearnedSelfAttentionLayer(nOut=w, nHeads=1,
                                             nQueries=HEADS["queries"]))
            .layer(LastTimeStep(LSTM(nOut=16)))
            .layer(OutputLayer(lossFunction="mcxent", nOut=2,
                               activation="softmax"))
            .setInputType(InputType.recurrent(w, HEADS["seq"]))
            .build())
    return MultiLayerNetwork(conf).init()


def _one_head_data():
    """One fixed batch: seeded features, ragged lengths T .. T/8 (padded
    steps zeroed), random labels."""
    b, t, w = HEADS["batch"], HEADS["seq"], HEADS["width"]
    rng = np.random.default_rng(HEADS["seed"])
    x = rng.standard_normal((b, t, w)).astype(np.float32)
    lengths = np.linspace(t, t // 8, b).round().astype(int)
    mask = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
    x *= mask[:, :, None]
    ds = DataSet(x, np.eye(2, dtype=np.float32)[rng.integers(0, 2, b)])
    ds.featuresMask = mask
    return ds


def _one_head_train():
    """The one-head stack trained graphed and eagerly from one init, a
    step of each in turns: the two nets' parameters, optimizer state and
    every step's loss equal bit for bit, the loss finite and falling, and
    flash_fwd, flash_bwd_dq and flash_bwd_dkv launched on every timed
    step of both arms (the graph's replays counted)."""
    ds = _one_head_data()
    net = _one_head_net()
    with _deterministic():
        arms = {"graph": net.clone(), "eager": net.clone()}
        del net
        losses = {a: [] for a in arms}
        wall = dict.fromkeys(arms, 0.0)
        launches = {a: dict.fromkeys(HEADS_KERNELS, 0) for a in arms}
        for step in range(HEADS["warmup"] + HEADS["steps"]):
            for arm, m in arms.items():
                before = _counts()
                t0 = time.perf_counter()
                m.fit(ds, cudaGraphs=arm == "graph")
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                after = _counts()
                losses[arm].append(m.score())
                if step >= HEADS["warmup"]:
                    wall[arm] += dt
                    for k in HEADS_KERNELS:
                        launches[arm][k] += after[k] - before[k]
        st = arms["graph"].fit_status()
        unequal = _unequal(arms["graph"], arms["eager"])
    steps = HEADS["steps"]
    per_step = {a: {k: n / steps for k, n in launches[a].items()}
                for a in arms}
    for arm in arms:
        log(f"[heads] one-head stack fit {arm}: {steps} timed steps of "
            f"B={HEADS['batch']} T={HEADS['seq']} nIn=nOut={HEADS['width']}"
            f" (D = {HEADS['width']}; learned Tq = {HEADS['queries']}) in "
            f"{wall[arm]:.3f} s ({wall[arm] * 1e3 / steps:.2f} ms/step); "
            f"loss {losses[arm][0]:.6f} -> {losses[arm][-1]:.6f}; "
            f"launches a step {per_step[arm]}")
    log(f"[heads] one-head stack graph vs eager: tensors not bit-identical "
        f"{unequal}; losses equal {losses['graph'] == losses['eager']}; "
        f"graph store {st['captures']} capture, {st['replays']} replays, "
        f"{st['degradations']} degradations, {st['eager_calls']} eager "
        f"calls")
    if any(unequal.values()) or losses["graph"] != losses["eager"]:
        raise AssertionError(f"heads: graph vs eager: {unequal}, "
                             f"{losses}")
    if (st["captures"], st["degradations"], st["eager_calls"]) != (1, 0, 0):
        raise AssertionError(f"heads: graph store {st}")
    loss = losses["graph"]
    if not all(np.isfinite(loss)) or not loss[-1] < loss[0]:
        raise AssertionError(f"heads: the loss did not fall: {loss}")
    if any(launches[a][k] < steps for a in arms for k in HEADS_KERNELS) \
            or launches["graph"] != launches["eager"]:
        raise AssertionError(f"heads: launches {launches}")
    return {"ms_per_step": {a: wall[a] * 1e3 / steps for a in arms},
            "losses": loss, "launches": launches["graph"],
            "launches_per_step": per_step["graph"],
            "store": {k: st[k] for k in ("captures", "replays",
                                         "degradations", "eager_calls")}}


def _heads_serving():
    """BertDecoder served at D = 256 (BERT-base width, 3 heads) and at
    D = 8 (bert_tiny: the dense cache, and the paged fp pool): each kernel
    server's streams equal the dense-attention server's, token for token,
    greedy and sampled alike, and each launched flash_fwd (prefill) and
    flash_decode (steps)."""
    out, launches = {}, dict.fromkeys(("flash_fwd", "flash_decode"), 0)
    tiny = bert_tiny(max_position_embeddings=512)
    base = bert_base(num_heads=3, num_layers=HEADS["base_layers"])
    for label, cfg, pagings in (
            (f"bert_base 3 heads D={base.head_dim} ({base.num_layers} "
             "layers)", base, ({},)),
            (f"bert_tiny D={tiny.head_dim}", tiny,
             ({}, dict(page_size=PAGED["page_size"],
                       pool_pages=PAGED["pool_pages"])))):
        params = init_bert_params(cfg, 0)
        reqs = _requests(cfg)
        want = _paged_server(cfg, params, reqs, f"heads: {label} dense "
                             "attention", attn_impl="dense")
        if any(want["launches"].values()):
            raise AssertionError(f"heads: {label}: the dense-attention "
                                 f"server launched {want['launches']}")
        for kw in pagings:
            what = f"heads: {label} kernels" + (" paged" if kw else "")
            run = _paged_server(cfg, params, reqs, what,
                                check_launches=True, **kw)
            diff = [i for i, (a, b) in enumerate(zip(run["streams"],
                                                     want["streams"]))
                    if a != b]
            log(f"[heads] {what}: streams equal to the dense-attention "
                f"server's {len(reqs) - len(diff)}/{len(reqs)}")
            if diff:
                raise AssertionError(f"heads: {what}: streams {diff} "
                                     f"differ from the dense-attention "
                                     f"server's")
            for k in launches:
                launches[k] += run["launches"][k]
            out[what] = {k: run[k] for k in (
                "tokens", "wall_s", "tokens_per_s", "per_token_p50_ms",
                "per_token_p99_ms", "launches")}
        out[f"{label} dense attention tokens_per_s"] = want["tokens_per_s"]
        del params
        torch.cuda.empty_cache()
    return out, launches


def phase_heads():
    """Attention at DL4J's default single head on the card: the one-head
    stack trained at D = 256, the wide layer at one head (D = 512), and
    BertDecoder served at D = 256 and D = 8. The counts are set to 0 before
    each part and read after it."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    out = {"train": _one_head_train()}
    torch.cuda.empty_cache()
    out["wide"] = _attention_wide(ATTN["one_head"], tag="heads")
    out["serving"], out["serving_launches"] = _heads_serving()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[heads] the phase {out['seconds']:.1f} s")
    return out


# -- phase 16: zoo -------------------------------------------------------------
#: the zoo's graph models on the card, f32, TF32 off, cuDNN's deterministic
#: algorithms: InceptionResNetV1 trained at its published width (the timed
#: path, the conv1x1+BN fusion on), YOLO2 serving detections, the other
#: seven built and stepped
ZOO = dict(batch=32, warmup=2, steps=10, check_steps=3, seed=13, forwards=5,
           yolo_batch=8, yolo_fit=3, conf=0.3, nms=0.4, small_batch=8,
           small_fit=2)
#: fused vs unfused on the card (outputs, the first step's loss): f32 sums
#: in another order, held to ZOO_RTOL of the largest unfused value
ZOO_RTOL = 1e-4
#: InceptionResNetV1's fused pairs at blocks (5, 10, 5): stem3, 3 in each
#: of 5 block35, 2 in each of 10 block17
IRV1_PAIRS = 36
#: the timed arms, in turns: (fusion, fit route)
ZOO_ARMS = (("fused", "graph"), ("fused", "eager"), ("unfused", "graph"))
#: published widths' parameter counts (the JAX package's `init()`)
ZOO_PARAMS = {"InceptionResNetV1": 11_565_192, "YOLO2": 67_445_065,
              "EfficientNet": 5_288_548}
#: the other seven at their default widths: zoo class -> the fused pairs
#: when it also runs fused (B5–B8 on its own shapes), else None
ZOO_OTHERS = {"UNet": (UNet, None), "TinyYOLO": (TinyYOLO, None),
              "SqueezeNet": (SqueezeNet, None), "Xception": (Xception, None),
              "FaceNetNN4Small2": (FaceNetNN4Small2, 21),
              "NASNet": (NASNet, None), "EfficientNet": (EfficientNet, 16)}


@contextlib.contextmanager
def _fusion(on):
    """DL4J_TPU_FUSE_CONV_BN set for the span (read at `init()`)."""
    before = os.environ.get("DL4J_TPU_FUSE_CONV_BN")
    os.environ["DL4J_TPU_FUSE_CONV_BN"] = "1" if on else "0"
    try:
        yield
    finally:
        if before is None:
            os.environ.pop("DL4J_TPU_FUSE_CONV_BN", None)
        else:
            os.environ["DL4J_TPU_FUSE_CONV_BN"] = before


def _fused_copy(net, pairs):
    """A copy of graph `net` (its weights and BN state) with the fusion
    decision taken on: `pairs` conv1x1+BN pairs must be marked."""
    m = net.clone()
    with _fusion(True):
        m._decide_fusion()
    if len(m._fused_pairs) != pairs:
        raise AssertionError(f"zoo: {len(m._fused_pairs)} fused pairs, "
                             f"expected {pairs}")
    return m


def yolo_labels(b, h, w, n_cls, seed):
    """One ground-truth box in a random cell per image, (x, y, w, h) in grid
    units and a one-hot class (the YOLOv2 head's label layout)."""
    rng = np.random.default_rng(seed)
    lab = np.zeros((b, h, w, 4 + n_cls), np.float32)
    for i in range(b):
        ci, cj = rng.integers(h), rng.integers(w)
        lab[i, ci, cj, :4] = (cj + rng.random(), ci + rng.random(),
                              1 + rng.random() * 2, 1 + rng.random() * 2)
        lab[i, ci, cj, 4 + rng.integers(n_cls)] = 1.0
    return lab


def _zoo_data(model, b, seed):
    """A seeded batch for `model` at its input shape: uniform images and
    its kind of labels (a binary mask for UNet, YOLO boxes on the 1/32 grid,
    one-hot classes otherwise)."""
    rng = np.random.default_rng(seed)
    h, w, c = model.inputShape
    x = rng.random((b, h, w, c), np.float32)
    if isinstance(model, UNet):
        y = (rng.random((b, h, w, 1)) > 0.5).astype(np.float32)
    elif hasattr(model, "priors"):   # YOLO2, TinyYOLO
        y = yolo_labels(b, h // 32, w // 32, model.numClasses, seed)
    else:
        y = np.eye(model.numClasses, dtype=np.float32)[
            rng.integers(0, model.numClasses, b)]
    return DataSet(x, y)


def _rel(a, b):
    """max |a − b| / max(1, max |b|)."""
    err, scl = _scaled_err(a, b)
    return err / scl


def _zoo_timed_arm(arm, m, ds):
    """ZOO["steps"] `fit` steps of `ds`, graphed or eager, with the peak
    memory the arm reached and its launches per step."""
    fusion, route = arm
    b, steps = ZOO["batch"], ZOO["steps"]
    it = ListDataSetIterator([ds] * steps, b)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    m.fit(it, cudaGraphs=route == "graph")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    per_step = {k: launches[k] / steps for k in TRAIN_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    loss = m.score()
    log(f"[zoo] InceptionResNetV1 fit {fusion} {route}: "
        f"{wall * 1e3 / steps:.2f} ms/step, {b * steps / wall:.1f} "
        f"images/s, loss {loss:.6f} at step {m.getIterationCount()}, peak "
        f"allocated {peak / 2**30:.3f} GiB over {base / 2**30:.3f} GiB held "
        f"before the arm; launches per step {per_step}")
    want = IRV1_PAIRS if fusion == "fused" else 0
    if any(n != want for n in per_step.values()) or not np.isfinite(loss):
        raise AssertionError(f"zoo: InceptionResNetV1 {arm}: launches per "
                             f"step {per_step} (expected {want} of each), "
                             f"loss {loss}")
    return {"arm": f"{fusion} {route}", "ms_per_step": wall * 1e3 / steps,
            "images_per_s": b * steps / wall, "loss": loss,
            "iteration": m.getIterationCount(), "peak_bytes": peak,
            "base_bytes": base, "launches": launches,
            "launches_per_step": per_step}


def _zoo_irv1():
    """InceptionResNetV1 at 160×160×3, blocks (5, 10, 5), 1000 classes:
    fused against unfused, graph against eager, then the timed arms."""
    with _fusion(True):
        fused = InceptionResNetV1().init(DEV)
    _perturb_bn(fused, ZOO["seed"])
    plain = fused.clone()
    plain._fused_pairs, plain._fused_convs = {}, set()
    n_params = fused.numParams()
    if (n_params != ZOO_PARAMS["InceptionResNetV1"]
            or len(fused._fused_pairs) != IRV1_PAIRS):
        raise AssertionError(f"zoo: InceptionResNetV1 {n_params} "
                             f"parameters, {len(fused._fused_pairs)} pairs")
    b = ZOO["batch"]
    ds = _zoo_data(InceptionResNetV1(), b, ZOO["seed"])
    x = torch.as_tensor(ds.features, device=DEV)
    with torch.no_grad():
        _reset_counts()
        yf = fused.output(x)
        torch.cuda.synchronize()
        epilogue = _counts()["matmul_epilogue"]
        yp = plain.output(x)
    out_err = _rel(yf, yp)
    fused_ms, fused_min = _forward_ms(fused, x)
    plain_ms, plain_min = _forward_ms(plain, x)
    h, w, c = InceptionResNetV1().inputShape
    log(f"[zoo] InceptionResNetV1 {h}x{w}x{c} f32, {n_params:,} parameters, "
        f"{len(fused._fused_pairs)} fused pairs: output B={b} fused vs "
        f"unfused max|err|/max(1, max|unfused|) {out_err:.3e} (rtol "
        f"{ZOO_RTOL:.0e}); {epilogue} matmul_epilogue launches in one "
        f"output(); one B={b} output() {fused_ms:.2f} ms fused (min "
        f"{fused_min:.2f}), {plain_ms:.2f} ms unfused (min {plain_min:.2f})")
    if not out_err <= ZOO_RTOL or epilogue != IRV1_PAIRS:
        raise AssertionError(f"zoo: InceptionResNetV1 output fused vs "
                             f"unfused {out_err}, epilogue launches "
                             f"{epilogue}")
    n = ZOO["check_steps"]
    identity = {}
    for fusion, net in (("fused", fused), ("unfused", plain)):
        graph, eager = net.clone(), net.clone()
        graph.fit(ListDataSetIterator([ds] * n, b))
        eager.fit([ds] * n, prefetch=0, cudaGraphs=False)
        torch.cuda.synchronize()
        unequal = _unequal(graph, eager)
        scores = (graph.score(), eager.score())
        st = graph.fit_status()
        identity[fusion] = {"unequal": unequal, "scores": scores,
                            "store": {k: st[k] for k in (
                                "captures", "replays", "degradations",
                                "eager_calls")}}
        log(f"[zoo] InceptionResNetV1 {fusion}, {n} steps graph vs eager: "
            f"not bit-identical {unequal}; loss {scores[0]!r} vs "
            f"{scores[1]!r}; store {identity[fusion]['store']}")
        if any(unequal.values()) or scores[0] != scores[1] or (
                st["captures"], st["replays"], st["degradations"],
                st["eager_calls"]) != (1, n - 1, 0, 0):
            raise AssertionError(f"zoo: InceptionResNetV1 {fusion} graph "
                                 f"vs eager: {identity[fusion]}")
        del graph, eager
    torch.cuda.empty_cache()
    nets = {arm: (fused if arm[0] == "fused" else plain).clone()
            for arm in ZOO_ARMS}
    del fused, plain
    first = {}
    for arm, m in nets.items():
        for i in range(ZOO["warmup"]):
            m.fit(ds, cudaGraphs=arm[1] == "graph")
            if i == 0:
                first[arm] = m.score()
    torch.cuda.synchronize()
    loss_err = abs(first["fused", "graph"] - first["unfused", "graph"]) / max(
        1.0, abs(first["unfused", "graph"]))
    log(f"[zoo] InceptionResNetV1 first step's loss: fused "
        f"{first['fused', 'graph']!r}, unfused "
        f"{first['unfused', 'graph']!r}, rel {loss_err:.3e}")
    if not loss_err <= ZOO_RTOL:
        raise AssertionError(f"zoo: first step's loss fused vs unfused "
                             f"{first}")
    runs = [_zoo_timed_arm(arm, nets[arm], ds) for arm in ZOO_ARMS]
    if runs[0]["loss"] != runs[1]["loss"]:
        raise AssertionError(f"zoo: InceptionResNetV1 fused graph and eager "
                             f"arms at one step disagree: {runs}")
    del nets
    torch.cuda.empty_cache()
    return {"params": n_params, "pairs": IRV1_PAIRS,
            "output_rel_err": out_err, "epilogue_launches": epilogue,
            "output_ms": {"fused": fused_ms, "unfused": plain_ms,
                          "fused_min": fused_min, "unfused_min": plain_min},
            "bit_identity": identity, "first_loss_rel_err": loss_err,
            "first_loss": {" ".join(a): v for a, v in first.items()},
            "runs": runs}


def _nms_oracle(xy, wh, conf, classes, conf_thr, iou_thr):
    """Indices kept by a greedy per-class NMS in numpy, f64, written from
    its definition: the boxes at or above the threshold by descending
    confidence (stable), each kept unless a kept box of its class overlaps
    it by more than `iou_thr` (IoU as the head computes it)."""
    xy, wh = xy.astype(np.float64), wh.astype(np.float64)
    cls = classes.argmax(-1)
    cand = np.nonzero(conf >= np.float32(conf_thr))[0]
    cand = cand[np.argsort(-conf[cand], kind="stable")]
    kept = []
    for i in cand:
        ok = True
        for j in kept:
            if cls[j] != cls[i]:
                continue
            lo = np.maximum(xy[i] - wh[i] / 2, xy[j] - wh[j] / 2)
            hi = np.minimum(xy[i] + wh[i] / 2, xy[j] + wh[j] / 2)
            inter = np.prod(np.clip(hi - lo, 0.0, None))
            union = (max(wh[i].prod(), 1e-9) + max(wh[j].prod(), 1e-9)
                     - inter + 1e-9)
            if inter / union > iou_thr:
                ok = False
                break
        if ok:
            kept.append(int(i))
    return kept


def _zoo_yolo2():
    """YOLO2 at 416×416×3, 80 classes, the COCO priors: detections served
    and held to the numpy oracle, then a few training steps."""
    model = YOLO2()
    net = model.init(DEV)
    _perturb_bn(net, ZOO["seed"])
    n_params = net.numParams()
    b = ZOO["yolo_batch"]
    ds = _zoo_data(model, b, ZOO["seed"] + 1)
    x = torch.as_tensor(ds.features, device=DEV)
    with torch.no_grad():
        out = net.output(x)
    out_ms, out_min = _forward_ms(net, x)
    head = net.getOutputLayer(0)
    thr = (ZOO["conf"], ZOO["nms"])
    dets = head.getPredictedObjects(out, *thr)
    times = []
    for _ in range(ZOO["forwards"]):
        t = time.perf_counter()
        head.getPredictedObjects(out, *thr)
        times.append((time.perf_counter() - t) * 1e3)
    t = time.perf_counter()
    whole = net.getPredictedObjects(x, *thr)
    whole_ms = (time.perf_counter() - t) * 1e3
    with torch.no_grad():
        dec = {k: v.cpu().numpy() for k, v in head.decode(out.float()).items()}
    n = dec["confidence"][0].size
    h, w, _ = model.inputShape
    grid = (b, h // 32, w // 32, len(model.priors) * (5 + model.numClasses))
    mismatched, per_example = [], []
    for i in range(b):
        xy, wh = dec["xy"][i].reshape(n, 2), dec["wh"][i].reshape(n, 2)
        conf = dec["confidence"][i].reshape(n)
        cls = dec["classes"][i].reshape(n, -1)
        want = sorted((float(xy[j, 0]), float(xy[j, 1]), float(wh[j, 0]),
                       float(wh[j, 1]), float(conf[j]))
                      for j in _nms_oracle(xy, wh, conf, cls, *thr))
        got = sorted((d.centerX, d.centerY, d.width, d.height, d.confidence)
                     for d in dets[i])
        per_example.append(len(got))
        if (got != want or any(d.exampleNumber != i for d in dets[i])
                or len(whole[i]) != len(got)):
            mismatched.append(i)
    log(f"[zoo] YOLO2 {h}x{w}x3 f32, {model.numClasses} classes, "
        f"{n_params:,} parameters: "
        f"output B={b} {tuple(out.shape)} in {out_ms:.2f} ms (min "
        f"{out_min:.2f}); getPredictedObjects(conf {thr[0]}, nms {thr[1]}) "
        f"on that output {np.mean(times):.2f} ms (min {np.min(times):.2f}), "
        f"with its forward {whole_ms:.2f} ms; detections per example "
        f"{per_example}; keep sets unequal to the numpy oracle at examples "
        f"{mismatched}")
    if (tuple(out.shape) != grid or mismatched
            or n_params != ZOO_PARAMS["YOLO2"]
            or not torch.isfinite(out).all()):
        raise AssertionError(f"zoo: YOLO2 output {tuple(out.shape)}, "
                             f"{n_params} parameters, keep sets unequal at "
                             f"{mismatched}")
    losses = []
    for _ in range(ZOO["yolo_fit"]):
        net.fit(ds)
        losses.append(net.score())
    log(f"[zoo] YOLO2 fit B={b} on synthetic boxes: losses {losses}")
    if not np.isfinite(losses).all():
        raise AssertionError(f"zoo: YOLO2 fit losses {losses}")
    del net
    torch.cuda.empty_cache()
    return {"params": n_params, "output_shape": list(out.shape),
            "output_ms": out_ms, "output_min_ms": out_min,
            "detect_ms": float(np.mean(times)), "detect_min_ms":
            float(np.min(times)), "detect_with_forward_ms": whole_ms,
            "detections_per_example": per_example, "losses": losses}


def _zoo_other(name):
    """One of the other seven at its default width: an output of the right
    shape and range, ZOO["small_fit"] `fit` steps with a finite score;
    with the fusion too where ZOO_OTHERS names its pairs."""
    cls, pairs = ZOO_OTHERS[name]
    model = cls()
    net = model.init(DEV)
    _perturb_bn(net, ZOO["seed"])
    b = ZOO["small_batch"]
    ds = _zoo_data(model, b, ZOO["seed"] + 2)
    x = torch.as_tensor(ds.features, device=DEV)
    h, w, _ = model.inputShape
    want = {"UNet": (b, h, w, 1),
            "TinyYOLO": (b, h // 32, w // 32, 5 * (5 + model.numClasses))
            }.get(name, (b, model.numClasses))
    fused = None if pairs is None else _fused_copy(net, pairs)
    with torch.no_grad():
        out = net.output(x)
        if fused is not None:
            _reset_counts()
            out_fused = fused.output(x)
            torch.cuda.synchronize()
            epilogue = _counts()["matmul_epilogue"]
    row = {"params": net.numParams(), "output_shape": list(out.shape)}
    bad = []
    if tuple(out.shape) != want or not torch.isfinite(out).all():
        bad.append(f"output {tuple(out.shape)} (expected {want})")
    if name == "UNet":
        row["mask_range"] = [out.min().item(), out.max().item()]
        if not (out.min() > 0 and out.max() < 1):
            bad.append(f"mask outside (0, 1): {row['mask_range']}")
    elif name != "TinyYOLO":
        row["row_sum_err"] = (out.double().sum(-1) - 1).abs().max().item()
        if not row["row_sum_err"] <= 1e-4:
            bad.append(f"softmax rows off 1 by {row['row_sum_err']}")
    arms = [("unfused", net)] + ([] if fused is None else [("fused", fused)])
    for arm, m in arms:
        losses = []
        _reset_counts()
        for _ in range(ZOO["small_fit"]):
            m.fit(ds)
            losses.append(m.score())
        torch.cuda.synchronize()
        row[f"{arm}_losses"] = losses
        row[f"{arm}_launches"] = {k: _counts()[k] for k in TRAIN_KERNELS}
        if not np.isfinite(losses).all():
            bad.append(f"{arm} fit losses {losses}")
        want_launches = (pairs or 0) * ZOO["small_fit"] if arm == "fused" \
            else 0
        if any(v != want_launches for v in row[f"{arm}_launches"].values()):
            bad.append(f"{arm} fit launches {row[f'{arm}_launches']} "
                       f"(expected {want_launches} of each)")
    if fused is not None:
        row["fused_output_rel_err"] = _rel(out_fused, out)
        row["fused_epilogue_launches"] = epilogue
        if not row["fused_output_rel_err"] <= ZOO_RTOL or epilogue != pairs:
            bad.append(f"fused output {row['fused_output_rel_err']}, "
                       f"epilogue launches {epilogue}")
    if name == "EfficientNet" and row["params"] != ZOO_PARAMS[name]:
        bad.append(f"{row['params']} parameters")
    log(f"[zoo] {name} {h}x{w}: {row}")
    if bad:
        raise AssertionError(f"zoo: {name}: {bad}")
    del net, fused
    torch.cuda.empty_cache()
    return row


def phase_zoo():
    """The zoo's graph models on the card, all under cuDNN's deterministic
    algorithms; the launch counts are set to 0 before each path and read
    after it."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    out = {}
    with _deterministic():
        out["irv1"] = _zoo_irv1()
        out["yolo2"] = _zoo_yolo2()
        out["others"] = {name: _zoo_other(name) for name in ZOO_OTHERS}
    # the path's kernels: B5, B7, B8 in the fused graphed steps, B6 in one
    # fused output()
    out["launches"] = {k: out["irv1"]["runs"][0]["launches"][k]
                       for k in TRAIN_KERNELS}
    out["launches"]["matmul_epilogue"] = out["irv1"]["epilogue_launches"]
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[zoo] the phase {out['seconds']:.1f} s")
    return out


# -- phase 17: layers -----------------------------------------------------------
#: this slice's families on the card, f32, TF32 off, cuDNN's deterministic
#: algorithms: CapsNet at Sabour et al.'s widths (arXiv:1710.09829 §4)
#: trained through MultiLayerNetwork.fit, the model archives (CapsNet and
#: InceptionResNetV1 saved and resumed), the VAE of dl4j-examples'
#: VariationalAutoEncoderExample pretrained, and each other new family
#: once against its CPU run
LAYERS = dict(batch=128, warmup=2, steps=10, check_steps=3, seed=17,
              resume_steps=3, vae_batch=128, vae_steps=20, family_batch=4)
#: 28×28×1 → conv 256 9×9 → PrimaryCapsules 32×8 9×9/2 (1152 capsules) →
#: CapsuleLayer 10×16, 3 routings: 20,992 + 5,308,672 + 1,474,560
CAPSNET_PARAMS = 6_804_224
LAYERS_ARMS = ("eager", "graph", "graph", "eager")
#: the card against its CPU run of the same net and parameters, relative
#: to max(1, max |CPU|)
FAMILY_RTOL = 1e-4
#: archives are written and read here (inside the checkout, gitignored)
CKPT_DIR = Path(__file__).resolve().parent / "build" / "layers_ckpt"


def _capsnet():
    conf = (NeuralNetConfiguration.Builder().seed(LAYERS["seed"])
            .updater(Adam(1e-3)).weightInit("xavier").list()
            .layer(ConvolutionLayer(kernelSize=(9, 9), stride=(1, 1),
                                    nOut=256, activation="relu"))
            .layer(PrimaryCapsules(capsuleDimensions=8, channels=32,
                                   kernelSize=(9, 9), stride=(2, 2)))
            .layer(CapsuleLayer(capsules=10, capsuleDimensions=16,
                                routings=3))
            .layer(CapsuleStrengthLayer())
            .layer(LossLayer(lossFunction="mcxent", activation="softmax"))
            .setInputType(InputType.convolutional(28, 28, 1)).build())
    return MultiLayerNetwork(conf).init(DEV)


def _caps_batch():
    rng = np.random.default_rng(LAYERS["seed"])
    b = LAYERS["batch"]
    return DataSet(rng.random((b, 28, 28, 1), np.float32),
                   np.eye(10, dtype=np.float32)[rng.integers(0, 10, b)])


def _layers_timed_arm(what, arm, m, ds, steps):
    """`steps` fit steps of `ds`, graphed or eager: ms/step, images/s, the
    loss and the peak allocated bytes; no kernel of the nine launched."""
    b = ds.features.shape[0]
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    losses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        m.fit(ds, cudaGraphs=arm == "graph")
        # a graph's loss lives in its store's pool, overwritten by the next
        # replay: a copy of each, read after the arm
        losses.append(m._score.clone())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _no_kernel_launched(f"{what} training ({arm})")
    losses = [float(v) for v in losses]
    peak = torch.cuda.max_memory_allocated()
    log(f"[layers] {what} fit {arm}: {wall * 1e3 / steps:.2f} ms/step, "
        f"{b * steps / wall:.1f} images/s, loss {losses[0]:.6f} -> "
        f"{losses[-1]:.6f} at step {m.getIterationCount()}, peak allocated "
        f"{peak / 2**30:.3f} GiB over {base / 2**30:.3f} GiB held before "
        "the arm")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"layers: {what} {arm}: losses {losses}")
    return {"arm": arm, "ms_per_step": wall * 1e3 / steps,
            "images_per_s": b * steps / wall, "losses": losses,
            "iteration": m.getIterationCount(), "peak_bytes": peak,
            "base_bytes": base}


def _save_restore(net, name, load):
    """`net` saved with its updater state and read back by `load` onto the
    card: (the restored net, the archive's bytes and seconds)."""
    CKPT_DIR.mkdir(parents=True, exist_ok=True)
    path = CKPT_DIR / f"{name}.zip"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.save(str(path), saveUpdater=True)
    save_s = time.perf_counter() - t0
    nbytes = path.stat().st_size
    t0 = time.perf_counter()
    back = load(str(path))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    path.unlink()
    log(f"[layers] {name} archive {nbytes:,} bytes, saved in {save_s:.3f} "
        f"s, restored onto the card in {restore_s:.3f} s")
    return back, {"bytes": nbytes, "save_s": save_s,
                  "restore_s": restore_s}


def _resume(what, net, back, ds, steps_counts=None):
    """The restored `back` against the uninterrupted `net`: output() on the
    batch bit for bit, then LAYERS["resume_steps"] graphed steps of each
    bit for bit (parameters, optimizer and BN state, loss). Returns the
    restored net's launches in one output() and in its resumed steps."""
    x = torch.as_tensor(ds.features, device=DEV)
    with torch.no_grad():
        _reset_counts()
        yb = back.output(x)
        torch.cuda.synchronize()
        out_launches = _counts()
        ya = net.output(x)
    same_out = torch.equal(ya, yb)
    n = LAYERS["resume_steps"]
    _reset_counts()
    for _ in range(n):
        back.fit(ds)
    torch.cuda.synchronize()
    step_launches = _counts()
    for _ in range(n):
        net.fit(ds)
    torch.cuda.synchronize()
    unequal = _unequal(net, back)
    scores = (net.score(), back.score())
    log(f"[layers] {what} restored: output() bit-identical {same_out}; "
        f"{n} resumed graphed steps vs {n} more of the uninterrupted net: "
        f"not bit-identical {unequal}, loss {scores[0]!r} vs {scores[1]!r}")
    if not same_out or any(unequal.values()) or scores[0] != scores[1]:
        raise AssertionError(f"layers: {what} resume: output equal "
                             f"{same_out}, {unequal}, {scores}")
    return {"output_equal": same_out, "unequal": unequal, "scores": scores,
            "output_launches": out_launches, "step_launches": step_launches}


def _layers_capsnet(profile=False):
    """CapsNet at its published widths: graph = eager bit for bit, the
    timed arms (with `profile`, 3 steps of each arm under torch.profiler),
    then its archive resumed."""
    net = _capsnet()
    n_params = net.numParams()
    if n_params != CAPSNET_PARAMS:
        raise AssertionError(f"layers: CapsNet {n_params} parameters")
    ds = _caps_batch()
    n = LAYERS["check_steps"]
    graph, eager = net.clone(), net.clone()
    for _ in range(n):
        graph.fit(ds)
        eager.fit(ds, cudaGraphs=False)
    torch.cuda.synchronize()
    unequal = _unequal(graph, eager)
    scores = (graph.score(), eager.score())
    st = graph.fit_status()
    log(f"[layers] CapsNet 28x28x1, {n_params:,} parameters, B="
        f"{LAYERS['batch']}, {n} steps graph vs eager: not bit-identical "
        f"{unequal}; loss {scores[0]!r} vs {scores[1]!r}; store "
        f"{st['captures']} capture, {st['replays']} replays")
    if any(unequal.values()) or scores[0] != scores[1] or (
            st["captures"], st["replays"], st["degradations"],
            st["eager_calls"]) != (1, n - 1, 0, 0):
        raise AssertionError(f"layers: CapsNet graph vs eager: {unequal}, "
                             f"{scores}, {st}")
    del graph, eager
    nets = {"eager": net.clone(), "graph": net.clone()}
    del net
    torch.cuda.empty_cache()
    for arm, m in nets.items():
        for _ in range(LAYERS["warmup"]):
            m.fit(ds, cudaGraphs=arm == "graph")
    torch.cuda.synchronize()
    runs = [_layers_timed_arm("CapsNet", arm, nets[arm], ds,
                              LAYERS["steps"]) for arm in LAYERS_ARMS]
    traced = {}
    for arm, m in nets.items():
        if profile:
            traced[arm], _ = _profiled(
                f"CapsNet training B={LAYERS['batch']}, 3 steps {arm}",
                lambda: [m.fit(ds, cudaGraphs=arm == "graph")
                         for _ in range(3)])
    back, ckpt = _save_restore(nets["graph"], "capsnet",
                               MultiLayerNetwork.load)
    resume = _resume("CapsNet", nets["graph"], back, ds)
    if any(resume["output_launches"].values()) or any(
            resume["step_launches"].values()):
        raise AssertionError(f"layers: CapsNet launched {resume}")
    del nets, back
    torch.cuda.empty_cache()
    return {"params": n_params, "bit_identity": {
        "steps": n, "unequal": unequal, "scores": scores},
        "runs": runs, "profile": traced, "checkpoint": ckpt,
        "resume": resume}


def _layers_irv1():
    """InceptionResNetV1 at its published width, fused, after 2 graphed
    steps: saved, restored onto the card with its fusion decision taken
    again, and resumed."""
    with _fusion(True):
        net = InceptionResNetV1().init(DEV)
    _perturb_bn(net, ZOO["seed"])
    ds = _zoo_data(InceptionResNetV1(), ZOO["batch"], ZOO["seed"])
    for _ in range(2):
        net.fit(ds)
    with _fusion(True):
        back, ckpt = _save_restore(net, "irv1", ComputationGraph.load)
    pairs = len(back._fused_pairs)
    resume = _resume("InceptionResNetV1", net, back, ds)
    n = LAYERS["resume_steps"]
    per_step = {k: resume["step_launches"][k] / n for k in TRAIN_KERNELS}
    epilogue = resume["output_launches"]["matmul_epilogue"]
    log(f"[layers] InceptionResNetV1 restored: {pairs} fused pairs, "
        f"{epilogue} matmul_epilogue launches in one output(), launches "
        f"per resumed step {per_step}")
    if pairs != IRV1_PAIRS or epilogue != IRV1_PAIRS or any(
            v != IRV1_PAIRS for v in per_step.values()):
        raise AssertionError(f"layers: InceptionResNetV1 restored: {pairs} "
                             f"pairs, {epilogue} epilogues, {per_step}")
    del net, back
    torch.cuda.empty_cache()
    return {"params": ZOO_PARAMS["InceptionResNetV1"], "pairs": pairs,
            "checkpoint": ckpt, "resume": resume,
            "launches_per_step": per_step}


def _layers_vae():
    """dl4j-examples' VariationalAutoEncoderExample: 784 → (256, 256) → 2,
    Bernoulli reconstruction, LeakyReLU, Xavier, l2 1e-4, RmsProp(1e-3),
    B = 128; 20 pretrainLayer steps on binarized synthetic digits. The
    negative ELBO of the first batch at one fixed ε must fall."""
    conf = (NeuralNetConfiguration.Builder().seed(LAYERS["seed"])
            .updater(RmsProp(1e-3)).weightInit("xavier").l2(1e-4).list()
            .layer(VariationalAutoencoder(
                nIn=784, nOut=2, encoderLayerSizes=(256, 256),
                decoderLayerSizes=(256, 256), activation="leakyrelu",
                pzxActivationFunction="identity",
                reconstructionDistribution=BernoulliReconstructionDistribution(
                    "sigmoid")))
            .setInputType(InputType.feedForward(784)).build())
    net = MultiLayerNetwork(conf).init(DEV)
    b, steps = LAYERS["vae_batch"], LAYERS["vae_steps"]
    it = MnistDataSetIterator(b, num_examples=b * steps,
                              root=str(CKPT_DIR / "no-mnist"))
    batches = [DataSet((ds.features > 0.5).astype(np.float32), ds.labels)
               for ds in it]
    x0 = torch.as_tensor(batches[0].features, device=DEV)
    layer = net.layers[0]

    def elbo():
        g = torch.Generator(device=DEV).manual_seed(0)
        with torch.no_grad():
            return float(layer.pretrain_loss(net._params["0"], x0, g))

    before = elbo()
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    net.pretrainLayer(0, ListDataSetIterator(batches, b))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = elbo()
    _no_kernel_launched("VAE pretraining")
    log(f"[layers] VAE 784-256-256-2, B={b}: {steps} pretrainLayer steps "
        f"in {wall * 1e3 / steps:.2f} ms/step; negative ELBO of batch 0 at "
        f"a fixed eps {before:.4f} -> {after:.4f}; last step's loss "
        f"{net.score():.4f}")
    if not (np.isfinite(after) and after < before):
        raise AssertionError(f"layers: VAE negative ELBO {before} -> {after}")
    return {"params": net.numParams(), "ms_per_step": wall * 1e3 / steps,
            "elbo_before": before, "elbo_after": after,
            "last_loss": net.score()}


class _Swish(SameDiffLayer):
    """A custom layer written on torch tensors: z·sigmoid(z), z = xW + b."""

    def __init__(self, nOut=None, **kw):
        super().__init__(**kw)
        self.nOut = nOut

    def defineParameters(self):
        return {"W": (self.nIn, self.nOut), "b": (self.nOut,)}

    def defineLayer(self, params, x, mask=None):
        z = x @ params["W"] + params["b"]
        return z * torch.sigmoid(z)


def _family_confs():
    """name -> (a maker of the configuration, its input shape, classes):
    each family at the reference tests' small shapes."""
    def b():
        return (NeuralNetConfiguration.Builder().seed(LAYERS["seed"])
                .updater(Nesterovs(1e-2, 0.9)).list())

    return {
        "3d": (lambda: b()
               .layer(Convolution3D(nOut=4, kernelSize=(3, 3, 3),
                                    convolutionMode="same",
                                    activation="relu"))
               .layer(Subsampling3DLayer(kernelSize=(2, 2, 2),
                                         stride=(2, 2, 2)))
               .layer(Deconvolution3D(nOut=3, kernelSize=(2, 2, 2),
                                      stride=(2, 2, 2), activation="tanh"))
               .layer(ZeroPadding3DLayer(padding=1))
               .layer(Cropping3D(cropping=1))
               .layer(Upsampling3D(size=1))
               .layer(OutputLayer(nOut=3))
               .setInputType(InputType.convolutional3D(8, 8, 8, 2)).build(),
               (8, 8, 8, 2), 3),
        "deconv2d k4 s2 p1, lrn": (
            lambda: b()
            .layer(ConvolutionLayer(kernelSize=(3, 3), nOut=8,
                                    convolutionMode="same",
                                    activation="relu"))
            .layer(Deconvolution2D(nOut=6, kernelSize=(4, 4), stride=(2, 2),
                                   padding=(1, 1), activation="tanh"))
            .layer(LocalResponseNormalization())
            .layer(GlobalPoolingLayer(poolingType="avg"))
            .layer(OutputLayer(nOut=3))
            .setInputType(InputType.convolutional(8, 8, 3)).build(),
            (8, 8, 3), 3),
        "locally connected 2d, prelu": (
            lambda: b()
            .layer(LocallyConnected2D(nOut=6, kernelSize=(3, 3)))
            .layer(PReLULayer(alphaInit=0.1))
            .layer(DenseLayer(nOut=8, activation="tanh"))
            .layer(OutputLayer(nOut=3))
            .setInputType(InputType.convolutional(8, 8, 3)).build(),
            (8, 8, 3), 3),
        "1d": (lambda: b()
               .layer(Convolution1DLayer(nOut=6, kernelSize=3,
                                         activation="relu"))
               .layer(Subsampling1DLayer(kernelSize=2, stride=2))
               .layer(Upsampling1D(size=2))
               .layer(ZeroPadding1DLayer(padding=1))
               .layer(Cropping1D(cropping=1))
               .layer(LocallyConnected1D(nOut=4, kernelSize=2))
               .layer(ElementWiseMultiplicationLayer(activation="tanh"))
               .layer(GlobalPoolingLayer(poolingType="max"))
               .layer(OutputLayer(nOut=3))
               .setInputType(InputType.recurrent(5, 12)).build(),
               (12, 5), 3),
        "samediff": (lambda: b()
                     .layer(DenseLayer(nOut=8, activation="tanh"))
                     .layer(_Swish(nOut=6))
                     .layer(OutputLayer(nOut=3))
                     .setInputType(InputType.feedForward(10)).build(),
                     (10,), 3),
        "weight noise": (lambda: b()
                         .layer(DenseLayer(nOut=64, activation="tanh",
                                           weightNoise=DropConnect(0.8)))
                         .layer(DenseLayer(nOut=8, activation="tanh",
                                           weightNoise=WeightNoise(
                                               {"type": "normal",
                                                "std": 0.01})))
                         .layer(OutputLayer(nOut=3))
                         .setInputType(InputType.feedForward(32)).build(),
                         (32,), 3),
    }


def _layers_family(name, make, shape, classes):
    """One forward and one fit step on the card and on the CPU from the same
    parameters: the outputs within FAMILY_RTOL before and after the step
    (weight noise: its draws come from each device's generator, so after
    its step the loss must be finite and DropConnect keep its rate)."""
    rng = np.random.default_rng(LAYERS["seed"])
    b = LAYERS["family_batch"]
    ds = DataSet(rng.standard_normal((b,) + shape).astype(np.float32),
                 np.eye(classes, dtype=np.float32)[
                     rng.integers(0, classes, b)])
    card = MultiLayerNetwork(make()).init(DEV)
    cpu = MultiLayerNetwork(make()).init("cpu")
    errs = [_rel(card.output(ds.features).cpu(), cpu.output(ds.features))]
    _reset_counts()
    card.fit(ds)
    torch.cuda.synchronize()
    _no_kernel_launched(f"family {name}")
    cpu.fit(ds)
    loss = card.score()
    noise = name == "weight noise"
    if noise:
        w = card._params["0"]["W"]
        keep = float((card.layers[0].weightNoise.apply_to_params(
            {"W": w}, card._generator)["W"] != 0).float().mean())
    else:
        errs.append(_rel(card.output(ds.features).cpu(),
                         cpu.output(ds.features)))
        keep = None
    log(f"[layers] {name}: card vs CPU max|err|/max(1, max|CPU|) "
        f"{', '.join(f'{e:.3e}' for e in errs)} (forward"
        f"{'' if noise else ', after one fit step'}; rtol "
        f"{FAMILY_RTOL:.0e}); loss {loss:.6f}"
        + ("" if keep is None else f"; DropConnect kept {keep:.4f} of W"))
    if max(errs) > FAMILY_RTOL or not np.isfinite(loss) or (
            keep is not None and abs(keep - 0.8) > 0.04):
        raise AssertionError(f"layers: {name}: errors {errs}, loss {loss}, "
                             f"kept {keep}")
    return {"errors": errs, "loss": loss, "dropconnect_kept": keep}


def phase_layers(profile=False):
    """This slice's families on the card under cuDNN's deterministic
    algorithms; the launch counts are set to 0 before each path and read
    after it. `profile`: CapsNet's steps under torch.profiler too."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    out = {}
    with _deterministic():
        out["capsnet"] = _layers_capsnet(profile)
        out["irv1"] = _layers_irv1()
        out["vae"] = _layers_vae()
        out["families"] = {name: _layers_family(name, *spec)
                           for name, spec in _family_confs().items()}
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    # the path's kernels: the restored InceptionResNetV1's resumed steps
    # (B5, B7, B8) and its output() (B6)
    res = out["irv1"]["resume"]
    out["launches"] = {k: res["step_launches"][k] for k in TRAIN_KERNELS}
    out["launches"]["matmul_epilogue"] = res["output_launches"][
        "matmul_epilogue"]
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[layers] the phase {out['seconds']:.1f} s")
    return out


# -- phase 18: resilience -----------------------------------------------------
#: training that survives faults and fits in memory, on ResNet-50 at its
#: published width (224×224×3, 1000 classes, f32, TF32 off, Nesterovs(0.01,
#: 0.9) as the resnet_train phase trains it, the BN draws of the resnet
#: phase), under cuDNN's deterministic algorithms. `ft_batches` seeded
#: synthetic batches of `batch` feed the fault-tolerant trainer; faults go
#: in at the trainer's data pull `data_fault_at`, at dispatch call
#: `retry_at` (transient), and as a kill after step `kill_after`
RESIL = dict(batch=32, size=224, warmup=2, steps=10, check_every=10,
             seed=19, lr=0.01, ft_batches=30, save_every=10, data_fault_at=5,
             retry_at=13, kill_after=22, rollback_clean=4, rollback_bad=6,
             remat_warmup=2, remat_steps=3, remat_big=(256, 128),
             stall_timeout=2.0, stall_sleep=3.0)
RESIL_ARMS = ("unguarded", "guarded", "guarded", "unguarded")
RESIL_DIR = Path(__file__).resolve().parent / "build" / "resilience"


def _resil_batches(n, seed, batch=None):
    """`n` seeded ResNet-50 batches, drawn in bulk."""
    rng = np.random.default_rng(seed)
    b, hw = batch or RESIL["batch"], RESIL["size"]
    x = rng.standard_normal((n, b, hw, hw, 3), dtype=np.float32)
    y = np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, (n, b))]
    return [DataSet(x[i], y[i]) for i in range(n)]


def _resil_net(fused):
    """ResNet-50 at its published width, fused or not, with the resnet
    phase's BN draws."""
    before = os.environ.get("DL4J_TPU_FUSE_CONV_BN")
    os.environ["DL4J_TPU_FUSE_CONV_BN"] = "1" if fused else "0"
    try:
        net = ResNet50(updater=Nesterovs(RESIL["lr"], 0.9)).init(DEV)
    finally:
        if before is None:
            os.environ.pop("DL4J_TPU_FUSE_CONV_BN", None)
        else:
            os.environ["DL4J_TPU_FUSE_CONV_BN"] = before
    _perturb_bn(net, RESNET["seed"])
    want = EPILOGUE_PAIRS if fused else 0
    if len(net._fused_pairs) != want:
        raise AssertionError(f"resilience: {len(net._fused_pairs)} fused "
                             f"pairs, expected {want}")
    return net


def _guardian_syncs():
    snap = mon.get_registry().snapshot()
    return sum(r["value"] for r in snap.get(mon.PIPELINE_SYNCS, [])
               if r.get("labels", {}).get("site") == "guardian")


def _resil_arm(what, net, batches, offset, guard=None, count=False):
    """RESIL["warmup"] + RESIL["steps"] graphed fit steps over `batches`
    from `offset`, under `guard` when given: ms/step of the timed steps,
    each step's loss (copied out of the graph's pool), the guardian's
    syncs and the launches of the timed steps."""
    n_warm, steps = RESIL["warmup"], RESIL["steps"]
    losses = []
    ctx = guard if guard is not None else contextlib.nullcontext()
    syncs0 = _guardian_syncs()
    with ctx:
        for i in range(n_warm):
            net.fit(batches[(offset + i) % len(batches)])
            losses.append(net._score.clone())
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        for i in range(n_warm, n_warm + steps):
            net.fit(batches[(offset + i) % len(batches)])
            losses.append(net._score.clone())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counts()
        syncs = _guardian_syncs() - syncs0     # before the exit's flush
    losses = [float(v) for v in losses]
    log(f"[resilience] {what}: {wall * 1e3 / steps:.2f} ms/step over "
        f"{steps} graphed steps, loss {losses[0]:.6f} -> {losses[-1]:.6f}"
        + (f", guardian syncs {syncs}" if guard is not None else ""))
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"resilience: {what}: losses {losses}")
    return {"ms_per_step": wall * 1e3 / steps, "losses": losses,
            "syncs": syncs, "launches": launches}


def _resil_guarded(base, batches):
    """Guarded against unguarded training of the fused net through its
    graphs, in turns; then a NaN batch refused on the card."""
    from deeplearning4j_tpu_torch.resilience.guardian import \
        TrainingGuardian
    nets = {"unguarded": base.clone(), "guarded": base.clone()}
    # spike detection off (warmup_steps): a healthy guarded run must be the
    # unguarded run, step for step
    g = TrainingGuardian(check_every=RESIL["check_every"],
                         warmup_steps=10**6)
    per = RESIL["warmup"] + RESIL["steps"]
    arms, seen = [], {"unguarded": 0, "guarded": 0}
    mon.enable()
    mon.get_registry().clear()
    try:
        for kind in RESIL_ARMS:
            arms.append((kind, _resil_arm(
                f"ResNet-50 fused B={RESIL['batch']} {kind}", nets[kind],
                batches, seen[kind], g if kind == "guarded" else None)))
            seen[kind] += per
            if kind == "guarded" and arms[-1][1]["syncs"] != \
                    per // RESIL["check_every"]:
                raise AssertionError(
                    f"resilience: {arms[-1][1]['syncs']} guardian syncs in "
                    f"{per} steps, expected {per // RESIL['check_every']}")
    finally:
        mon.disable()
    ug, gd = nets["unguarded"], nets["guarded"]
    unequal = _unequal(ug, gd)
    loss_u = [a["losses"] for k, a in arms if k == "unguarded"]
    loss_g = [a["losses"] for k, a in arms if k == "guarded"]
    if any(unequal.values()) or loss_u != loss_g or g.skipped:
        raise AssertionError(f"resilience: guarded != unguarded: {unequal}, "
                             f"losses equal {loss_u == loss_g}, skipped "
                             f"{g.skipped}")
    # a NaN in one batch's labels: refused on the card, the parameters
    # equal those of the unguarded run that skipped that batch
    bad = DataSet(batches[0].features, batches[0].labels * np.nan)
    nxt = batches[1]
    with g:
        gd.fit(bad)
        gd.fit(nxt)
        ok = g.verify_now()
    ug.fit(nxt)
    torch.cuda.synchronize()
    unequal_nan = _unequal(ug, gd)
    if any(unequal_nan.values()) or g.skipped != 1 or not ok:
        raise AssertionError(f"resilience: NaN batch: not refused exactly "
                             f"({unequal_nan}, skipped {g.skipped}, "
                             f"healthy after the next step {ok})")
    st = gd.fit_status()
    # B6 on this path: one output() of the guarded net
    x = torch.as_tensor(batches[2].features, device=DEV)
    with torch.no_grad():
        _reset_counts()
        gd.output(x)
        torch.cuda.synchronize()
        epi = _counts()["matmul_epilogue"]
    timed = [a for k, a in arms if k == "guarded"][0]
    launches = {k: timed["launches"][k] for k in TRAIN_KERNELS}
    launches["matmul_epilogue"] = epi
    per_step = {k: timed["launches"][k] / RESIL["steps"]
                for k in TRAIN_KERNELS}
    if any(v != EPILOGUE_PAIRS for v in per_step.values()) \
            or epi != EPILOGUE_PAIRS:
        raise AssertionError(f"resilience: launches per guarded step "
                             f"{per_step}, output() epilogues {epi}")
    ms = {k: [a["ms_per_step"] for kk, a in arms if kk == k]
          for k in ("unguarded", "guarded")}
    cost = float(np.mean(ms["guarded"]) / np.mean(ms["unguarded"]) - 1.0)
    log(f"[resilience] guarded vs unguarded ms/step {ms['guarded']} vs "
        f"{ms['unguarded']}: the guard costs {cost * 100:+.2f} %; "
        f"bit-identical over {2 * per} steps and after a NaN batch "
        f"(refused on the card, skipped {g.skipped}); guardian checks "
        f"{g.checks}; launches per guarded step {per_step}; fit store "
        f"{st['captures']} captures, {st['replays']} replays, "
        f"{st['degradations']} degradations")
    if st["degradations"]:
        raise AssertionError(f"resilience: degraded keys {st['degraded']}")
    return {"arms": arms, "ms": ms, "guard_cost": cost,
            "launches": launches, "launches_per_step": per_step,
            "skipped": g.skipped, "checks": g.checks,
            "captures": st["captures"], "replays": st["replays"]}, gd


def _dispatch_call_of(position, data_fault_at, retry_at):
    """The TRAIN_DISPATCH call that dispatches iterator position
    `position` when the pull `data_fault_at` is dropped and the dispatch
    call `retry_at` is retried once."""
    call = 0
    for p in range(1, position + 1):
        if p == data_fault_at:
            continue
        call += 1
        if call == retry_at:
            call += 1
    return call


def _resil_ft(base, batches):
    """FaultTolerantTrainer with verified checkpoints over the fused graph:
    a data fault, a transient dispatch fault and a kill, resumed by a new
    trainer, against the uninterrupted run with the same data fault."""
    from deeplearning4j_tpu_torch.resilience import integrity
    from deeplearning4j_tpu_torch.resilience.errors import \
        FatalTrainingError
    from deeplearning4j_tpu_torch.resilience.trainer import \
        FaultTolerantTrainer
    shutil.rmtree(RESIL_DIR, ignore_errors=True)
    b, every = RESIL["batch"], RESIL["save_every"]
    pol = RetryPolicy(max_attempts=3, initial_backoff=0.0,
                      sleep=lambda s: None)

    def source():
        return ListDataSetIterator(batches, b)

    t0 = time.perf_counter()
    ref = FaultTolerantTrainer(base.clone(), RESIL_DIR / "ref",
                               save_every=every, retry_policy=pol)
    with faults.FaultPlan(seed=1).fail_at(faults.DATA_NEXT,
                                          RESIL["data_fault_at"]):
        ref.fit(source())
    ref.close()
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    kill = _dispatch_call_of(RESIL["kill_after"] + 1,
                             RESIL["data_fault_at"], RESIL["retry_at"])
    plan = (faults.FaultPlan(seed=2)
            .fail_at(faults.DATA_NEXT, RESIL["data_fault_at"])
            .fail_at(faults.TRAIN_DISPATCH, RESIL["retry_at"])
            .fail_at(faults.TRAIN_DISPATCH, kill,
                     exc=lambda s, n: FatalTrainingError(f"kill at {s}#{n}")))
    t1 = FaultTolerantTrainer(base.clone(), RESIL_DIR / "run",
                              save_every=every, retry_policy=pol)
    killed = False
    with plan:
        try:
            t1.fit(source())
        except FatalTrainingError:
            killed = True
        t1.close()
        t2 = FaultTolerantTrainer(base.clone(), RESIL_DIR / "run",
                                  save_every=every, retry_policy=pol)
        _reset_counts()
        t2.fit(source())
        torch.cuda.synchronize()
        resumed_launches = _counts()
    m_ref, m2 = ref.model, t2.model
    unequal = _unequal(m_ref, m2)
    gen_equal = torch.equal(m_ref._generator.get_state(),
                            m2._generator.get_state())
    counters = ((m_ref._iteration, m2._iteration),
                (ref.skipped, t1.skipped + t2.skipped))
    log(f"[resilience] FaultTolerantTrainer over {len(batches)} batches of "
        f"{b}, save_every={every}: killed {killed} after step "
        f"{t1.step}, resumed from {t2.resumed_step}; retries "
        f"{t1.retries}; skipped {t1.skipped} (data fault); final state vs "
        f"the uninterrupted run not bit-identical {unequal}, generator "
        f"equal {gen_equal}, iterations {counters[0]}, skips "
        f"{counters[1]}; the uninterrupted run {ref_s:.1f} s")
    resume_at = RESIL["kill_after"] // every * every
    if (not killed or t2.resumed_step != resume_at or t1.retries != 1
            or t1.skipped != 1 or any(unequal.values()) or not gen_equal
            or counters[0][0] != counters[0][1]
            or counters[1][0] != counters[1][1]):
        raise AssertionError(f"resilience: fault-tolerant run differs: "
                             f"killed {killed}, resumed "
                             f"{t2.resumed_step}, retries {t1.retries}, "
                             f"skipped {t1.skipped}, {unequal}, generator "
                             f"{gen_equal}, {counters}")
    resumed_steps = RESIL["ft_batches"] - resume_at
    per_step = {k: resumed_launches[k] / resumed_steps
                for k in TRAIN_KERNELS}
    # a checkpoint's cost: bytes, save, restore, checksum
    ck = t2.ckpt
    step = ck.latest_step()
    nbytes = ck.step_bytes(step)
    torch.cuda.synchronize()
    s0 = time.perf_counter()
    t2._save_network(wait=True)
    save_s = time.perf_counter() - s0
    like = t2._like()
    s0 = time.perf_counter()
    rstep, state = ck.restore(step=step, like=like)
    read_s = time.perf_counter() - s0
    s0 = time.perf_counter()
    verdict = integrity.verify_restored(ck.directory, rstep, state)
    check_s = time.perf_counter() - s0
    s0 = time.perf_counter()
    t2._load_network_state(state)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - s0
    t2.close()
    # a corrupt newest manifest: restore_verified falls back a generation,
    # and the restored net keeps its 36 fused pairs
    with faults.FaultPlan(seed=3).fail_at(faults.CHECKPOINT_CORRUPT, 1):
        t3 = FaultTolerantTrainer(base.clone(), RESIL_DIR / "run",
                                  save_every=every)
        fell_back = t3.resume_or_init()
    pairs = len(t3.model._fused_pairs)
    _reset_counts()
    t3.model.fit(batches[0])
    torch.cuda.synchronize()
    after = {k: v for k, v in _counts().items() if k in TRAIN_KERNELS}
    t3.close()
    log(f"[resilience] checkpoint of step {step}: {nbytes:,} bytes; "
        f"save {save_s:.3f} s (snapshot and write, waited), read "
        f"{read_s:.3f} s, checksums {check_s:.3f} s ({verdict}), into "
        f"the live tensors {load_s:.3f} s; a corrupt newest manifest "
        f"falls back to step {fell_back}; the restored net keeps {pairs} "
        f"fused pairs, one step launches {after}; resumed steps launch "
        f"{per_step} per step")
    if fell_back != step - every or pairs != EPILOGUE_PAIRS or any(
            v != EPILOGUE_PAIRS for v in after.values()) or any(
            v != EPILOGUE_PAIRS for v in per_step.values()) \
            or verdict != "verified":
        raise AssertionError(f"resilience: fallback {fell_back}, pairs "
                             f"{pairs}, launches {after} {per_step}, "
                             f"{verdict}")
    return {"killed_after": t1.step, "resumed_step": t2.resumed_step,
            "retries": t1.retries, "skipped": t1.skipped,
            "ckpt_bytes": nbytes, "save_s": save_s, "read_s": read_s,
            "checksum_s": check_s, "load_s": load_s,
            "async_write_s": ref.ckpt.last_save[2],
            "fallback_step": fell_back, "ref_s": ref_s,
            "resumed_launches_per_step": per_step}


def _resil_ft_cost(base, batches):
    """FaultTolerantTrainer.fit against the bare graphed fit on the same
    batches, in turns, each arm a fresh clone warmed by RESIL["warmup"]
    bare steps: ms/step over RESIL["steps"] batches (the trainer's up to
    its end-of-fit save, which is timed apart), the peak allocated bytes
    above what was held at the arm's start, and the bytes still resident
    after it (the trainer's device snapshot of the training state, which
    its exact retry restores)."""
    from deeplearning4j_tpu_torch.resilience.trainer import \
        FaultTolerantTrainer
    n_warm, steps, b = RESIL["warmup"], RESIL["steps"], RESIL["batch"]
    timed = batches[n_warm:n_warm + steps]
    arms = []
    for i, kind in enumerate(("bare", "trainer", "trainer", "bare")):
        net = base.clone()
        for ds in batches[:n_warm]:
            net.fit(ds)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        stamp = {}
        t0 = time.perf_counter()
        if kind == "bare":
            net.fit(ListDataSetIterator(timed, b))
            torch.cuda.synchronize()
            stamp["steps"] = time.perf_counter()
            stamp["peak"] = torch.cuda.max_memory_allocated()
            trainer = None
        else:
            trainer = FaultTolerantTrainer(net, RESIL_DIR / f"cost{i}",
                                           save_every=10**6)
            save = trainer._maybe_save

            def _stamped_save(g, wait=False, save=save):
                torch.cuda.synchronize()
                stamp["steps"] = time.perf_counter()
                stamp["peak"] = torch.cuda.max_memory_allocated()
                return save(g, wait=wait)

            trainer._maybe_save = _stamped_save
            trainer.fit(ListDataSetIterator(timed, b))
            torch.cuda.synchronize()
        end = time.perf_counter()
        resident = torch.cuda.memory_allocated() - held
        if trainer is not None:
            trainer.close()
        arm = {"kind": kind,
               "ms_per_step": (stamp["steps"] - t0) * 1e3 / steps,
               "end_save_s": end - stamp["steps"],
               "peak_above_bytes": stamp["peak"] - held,
               "resident_bytes": resident, "held_bytes": held}
        if net._iteration != n_warm + steps or not np.isfinite(
                net.score()):
            raise AssertionError(f"resilience: trainer cost arm {arm}, "
                                 f"iterations {net._iteration}")
        arms.append(arm)
        log(f"[resilience] {kind} fit of {steps} batches of {b}: "
            f"{arm['ms_per_step']:.2f} ms/step, peak allocated "
            f"{arm['peak_above_bytes']:,} bytes above the "
            f"{held:,} held, {resident:,} still resident after"
            + (f", end-of-fit save {arm['end_save_s']:.3f} s"
               if trainer is not None else ""))
        del net, trainer
        torch.cuda.empty_cache()
    ms = {k: [a["ms_per_step"] for a in arms if a["kind"] == k]
          for k in ("bare", "trainer")}
    cost = float(np.mean(ms["trainer"]) / np.mean(ms["bare"]) - 1.0)
    log(f"[resilience] FaultTolerantTrainer vs bare fit ms/step "
        f"{ms['trainer']} vs {ms['bare']}: the trainer costs "
        f"{cost * 100:+.2f} %")
    return {"arms": arms, "ms": ms, "cost": cost}


def _resil_rollback(base, batches):
    """The ladder to its rollback rung: clean batches, then NaN ones."""
    from deeplearning4j_tpu_torch.resilience import integrity
    from deeplearning4j_tpu_torch.resilience.errors import DivergenceError
    from deeplearning4j_tpu_torch.resilience.guardian import \
        TrainingGuardian
    from deeplearning4j_tpu_torch.resilience.trainer import \
        FaultTolerantTrainer
    clean = RESIL["rollback_clean"]
    data = list(batches[:clean]) + [
        DataSet(d.features, d.labels * np.nan)
        for d in batches[clean:clean + RESIL["rollback_bad"]]]
    g = TrainingGuardian(check_every=1, max_skips=1, max_lr_retries=1,
                         max_rollbacks=1, warmup_steps=10**6)
    t = FaultTolerantTrainer(base.clone(), RESIL_DIR / "rollback",
                             save_every=clean, prefetch=0,
                             skip_non_finite=False, guardian=g)
    mon.enable()
    mon.get_registry().clear()
    diverged = False
    try:
        t.fit(data)
    except DivergenceError:
        diverged = True
    finally:
        reg = mon.get_registry()
        rollbacks = reg.get(mon.GUARDIAN_ROLLBACKS)
        rollbacks = None if rollbacks is None else rollbacks.value
        mon.disable()
    like = t._like()
    _, state = t.ckpt.restore(step=clean, like=like)
    live = integrity.flatten({"params": t.model._params,
                              "opt_state": t.model._opt_state,
                              "net_state": t.model._state})
    disk = integrity.flatten({"params": state["params"],
                              "opt_state": state["opt_state"],
                              "net_state": state["extra"]["net_state"]})
    same = sum(not torch.equal(a.cpu(), b) for (_, a), (_, b)
               in zip(live, disk))
    t.close()
    log(f"[resilience] rollback: {clean} clean then "
        f"{RESIL['rollback_bad']} NaN batches: diverged {diverged}, "
        f"rollbacks {g.rollbacks} (dl4j.guardian.rollbacks {rollbacks}), "
        f"skipped {g.skipped}, lr_scale {g.lr_scale}; leaves differing "
        f"from the step-{clean} checkpoint {same}")
    if not diverged or g.rollbacks != 1 or rollbacks != 1 or same:
        raise AssertionError(f"resilience: rollback: diverged {diverged}, "
                             f"{g.rollbacks} / {rollbacks} rollbacks, "
                             f"{same} leaves off the checkpoint")
    return {"rollbacks": g.rollbacks, "skipped": g.skipped,
            "lr_retries": g.lr_retries}


def _resil_watchdog(net, batches):
    """A StallWatchdog (2 s) around a guarded graphed fit whose second
    step sleeps past the timeout."""
    from deeplearning4j_tpu_torch.resilience.guardian import \
        TrainingGuardian
    from deeplearning4j_tpu_torch.resilience.watchdog import StallWatchdog
    wd = StallWatchdog(stall_timeout=RESIL["stall_timeout"],
                       poll_interval=0.1,
                       dump_dir=str(RESIL_DIR / "stall")).start()
    real = net._run_step
    calls = []

    def _stalled_step(batches_, graphs):
        calls.append(1)
        if len(calls) == 2:
            threading.Event().wait(RESIL["stall_sleep"])
        return real(batches_, graphs)

    net._run_step = _stalled_step
    wd.arm()
    try:
        with TrainingGuardian(check_every=RESIL["check_every"],
                              warmup_steps=10**6):
            for ds in batches[:3]:
                net.fit(ds)
        torch.cuda.synchronize()
    finally:
        wd.disarm()
        wd.stop()
        del net._run_step
    report = Path(wd.last_report_path).read_text() \
        if wd.last_report_path else ""
    named = "_stalled_step" in report
    log(f"[resilience] watchdog ({RESIL['stall_timeout']} s) over a step "
        f"that slept {RESIL['stall_sleep']} s: stalls {wd.stall_count}, "
        f"latched {wd.stalled} after the next beat, the report names the "
        f"stalled stack {named} ({wd.last_report_path})")
    if wd.stall_count != 1 or wd.stalled or not named:
        raise AssertionError(f"resilience: watchdog stalls "
                             f"{wd.stall_count}, stalled {wd.stalled}, "
                             f"named {named}")
    return {"stalls": wd.stall_count, "report": wd.last_report_path}


def _with_policy(net, policy):
    """A clone of `net` under `rematPolicy(policy)` (its own
    configuration; the layers are shared)."""
    m = net.clone()
    m.conf = copy.copy(net.conf)
    m.conf.remat_policy = policy
    return m


def _leaf_rel(a, b):
    """max over the leaves of max |a − b| / max |b|."""
    return max(((x.double() - y.double()).abs().max()
                / y.double().abs().max().clamp_min(1e-300)).item()
               for x, y in zip(tensor_leaves(a), tensor_leaves(b)))


def _remat_arm(what, net, batches, graphs):
    n_warm, steps = RESIL["remat_warmup"], RESIL["remat_steps"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base_b = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for i in range(n_warm):
        net.fit(batches[i % len(batches)], cudaGraphs=graphs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_warm, n_warm + steps):
        net.fit(batches[i % len(batches)], cudaGraphs=graphs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    b = batches[0].features.shape[0]
    above = (peak - base_b) / 2**30
    log(f"[resilience] remat {what}: {wall * 1e3 / steps:.2f} ms/step, "
        f"peak allocated {peak / 2**30:.3f} GiB ({above:.3f} above the "
        f"{base_b / 2**30:.3f} held before), B={b}")
    if not np.isfinite(net.score()):
        raise AssertionError(f"resilience: remat {what}: loss "
                             f"{net.score()}")
    return {"ms_per_step": wall * 1e3 / steps, "peak_bytes": peak,
            "base_bytes": base_b, "above_bytes": peak - base_b, "batch": b}


def _resil_remat(batches):
    """rematPolicy("blocks") on the unfused net against none."""
    base = _resil_net(fused=False)
    ins, labels, _ = base._unpack(batches[0])
    plain, remat = _with_policy(base, "none"), _with_policy(base, "blocks")
    lp, gp, sp = plain._value_and_grad(ins, labels)
    lr, gr, sr = remat._value_and_grad(ins, labels)
    bits = (torch.equal(lp, lr) and all(
        torch.equal(a, b) for a, b in zip(tensor_leaves((gp, sp)),
                                          tensor_leaves((gr, sr)))))
    rel = 0.0 if bits else _leaf_rel(gr, gp)
    del plain, remat, gp, gr, sp, sr
    how = "bit for bit" if bits else f"within {rel:.3e} relative"
    log(f"[resilience] remat first step: gradients, BN state and loss "
        f"with rematPolicy(\"blocks\") {how} of none "
        f"({len(base.conf.remat_plan())} segments)")
    if not bits and not rel <= 1e-6:
        raise AssertionError(f"resilience: remat gradients off by {rel}")
    arms = {}
    nets = {}
    for policy, graphs in (("none", True), ("blocks", True),
                           ("blocks", False), ("none", False)):
        key = f"{policy} {'graph' if graphs else 'eager'}"
        nets[key] = _with_policy(base, policy)
        arms[key] = _remat_arm(f"{key} B={RESIL['batch']}", nets[key],
                               batches, graphs)
        if policy == "none":
            nets[key] = None
    g_e = _unequal(nets["blocks graph"], nets["blocks eager"])
    log(f"[resilience] remat blocks graph vs eager after "
        f"{RESIL['remat_warmup'] + RESIL['remat_steps']} steps: not "
        f"bit-identical {g_e}")
    if any(g_e.values()):
        raise AssertionError(f"resilience: remat graph != eager: {g_e}")
    del nets
    torch.cuda.empty_cache()
    # the largest batch the run without remat fits at
    big = {}
    for b in RESIL["remat_big"]:
        data = _resil_batches(2, RESIL["seed"] + 7, batch=b)
        try:
            m = _with_policy(base, "none")
            big["none"] = _remat_arm(f"none eager B={b}", m, data, False)
        except torch.cuda.OutOfMemoryError:
            log(f"[resilience] remat: B={b} does not fit without remat")
            m = None
            big.clear()
            torch.cuda.empty_cache()
            continue
        del m
        m = _with_policy(base, "blocks")
        big["blocks"] = _remat_arm(f"blocks eager B={b}", m, data, False)
        del m
        break
    torch.cuda.empty_cache()
    if not big:
        raise AssertionError("resilience: no batch of "
                             f"{RESIL['remat_big']} fits without remat")
    cut = 1.0 - big["blocks"]["above_bytes"] / big["none"]["above_bytes"]
    cost = big["blocks"]["ms_per_step"] / big["none"]["ms_per_step"] - 1.0
    log(f"[resilience] remat at B={big['none']['batch']}: blocks costs "
        f"{cost * 100:+.1f} % of the step and cuts the peak above the "
        f"held bytes by {cut * 100:.1f} %")
    return {"first_step_bits": bits, "first_step_rel": rel, "arms": arms,
            "big": big, "big_cost": cost, "big_cut": cut}


def _resil_vgg_layers():
    """VGG16 (MultiLayerNetwork, dropout 0.5 in its dense layers) under
    rematPolicy("layers") against none, graphed: equal after the same
    steps, with each arm's ms/step and peak allocated bytes (remat keeps
    each dropout's boolean keep mask)."""
    net = VGG16(updater=Nesterovs(1e-2, 0.9)).init(DEV)
    plain = net.clone()
    remat = net.clone()
    del net
    remat.conf = copy.deepcopy(remat.conf)
    remat.conf.remat_policy = "layers"
    remat.layers = remat.conf.layers
    for layer in remat.layers:
        layer.remat = True
    ds = [_vgg_batch()]
    arms = {"none": _remat_arm("VGG16 none graph", plain, ds, True),
            "layers": _remat_arm("VGG16 layers graph", remat, ds, True)}
    unequal = _unequal(plain, remat)
    st = remat.fit_status()
    steps = RESIL["remat_warmup"] + RESIL["remat_steps"]
    cut = 1.0 - arms["layers"]["above_bytes"] / arms["none"]["above_bytes"]
    log(f"[resilience] VGG16 rematPolicy(\"layers\") {steps} graphed "
        f"steps vs none: not bit-identical {unequal}, loss "
        f"{plain.score()!r} vs {remat.score()!r}; store {st['captures']} "
        f"captures, {st['degradations']} degradations; the peak above "
        f"the held bytes cut {cut * 100:.1f} %")
    if any(unequal.values()) or plain.score() != remat.score() \
            or st["degradations"]:
        raise AssertionError(f"resilience: VGG16 remat: {unequal}, "
                             f"{st['degraded']}")
    return {"unequal": unequal, "loss": remat.score(), "arms": arms,
            "cut": cut}


def _resil_ops_runtime():
    """`nd` draws and Transforms on the card against the CPU; the native
    runtime against numpy; the op executioner's counts."""
    from deeplearning4j_tpu_torch.ops import Transforms, nd
    from deeplearning4j_tpu_torch.runtime import native_lib
    from deeplearning4j_tpu_torch.runtime.executioner import OpExecutioner
    errs = {}
    nd.setDevice(DEV)
    try:
        nd.setSeed(7)
        card = nd.rand(256, 512)
        nd.setDevice("cpu")
        nd.setSeed(7)
        host = nd.rand(256, 512)
        if not torch.equal(card.tensor.cpu(), host.tensor):
            raise AssertionError("resilience: nd.rand on the card differs "
                                 "from the CPU draw")
        nd.setDevice(DEV)
        x = nd.randn(512, 512)
    finally:
        nd.setDevice(None)
    xc = x.tensor.cpu()
    for name in ("exp", "tanh", "sigmoid", "relu", "gelu", "swish", "mish",
                 "softPlus", "erf", "hardTanh", "softmax", "logSoftmax",
                 "sqrt", "log1p"):
        arg = x.abs() if name in ("sqrt", "log1p") else x
        argc = xc.abs() if name in ("sqrt", "log1p") else xc
        got = getattr(Transforms, name)(arg).tensor.cpu()
        want = getattr(Transforms, name)(argc).tensor
        errs[name] = _rel(got, want)
    bad = {k: v for k, v in errs.items() if not v <= 1e-5}
    if bad:
        raise AssertionError(f"resilience: Transforms on the card: {bad}")
    if not native_lib.available():
        raise AssertionError("resilience: the native runtime did not build")
    rng = np.random.default_rng(3)
    arch = rng.integers(0, 256, (64, 28, 28), dtype=np.uint8)
    idx = rng.integers(0, 64, 32)
    got = native_lib.gather_batch_u8(arch, idx, scale=1 / 255.0)
    np.testing.assert_allclose(got, arch[idx].astype(np.float32) / 255,
                               rtol=1e-6)
    labels = rng.integers(0, 10, 64).astype(np.uint8)
    np.testing.assert_array_equal(native_lib.one_hot_u8(labels, idx, 10),
                                  np.eye(10, dtype=np.float32)[labels[idx]])
    img = rng.integers(0, 256, (224, 224, 3), dtype=np.uint8)
    np.testing.assert_allclose(native_lib.resize_bilinear_u8(img, 64, 64),
                               native_lib._resize_bilinear_oracle(img, 64,
                                                                  64),
                               atol=1e-3)
    ex = OpExecutioner.getInstance()
    ex.setProfilingMode(True)
    ex.op_counts.clear()
    y = torch.randn(2048, 2048, device=DEV)

    def square_matmul(a):
        return a @ a

    for _ in range(5):
        ex.exec(square_matmul, y)
    ex.setProfilingMode(False)
    stats = ex.getProfilingStats()["square_matmul"]
    log(f"[resilience] ops: nd.rand equal to the CPU draw; Transforms on "
        f"the card within {max(errs.values()):.3e} of the CPU; native "
        f"runtime built ({native_lib._so_path()}), gather/one-hot/"
        f"bilinear equal to numpy; OpExecutioner counted "
        f"{stats['count']} calls, "
        f"{stats['total_time_s'] * 1e3 / max(stats['count'], 1):.3f} ms "
        "each (CUDA events)")
    if stats["count"] != 5 or not stats["total_time_s"] > 0:
        raise AssertionError(f"resilience: executioner {stats}")
    return {"transforms_rel": errs, "executioner": stats}


def phase_resilience():
    """Training that survives faults and fits in memory (phase 18); the
    launch counts are set to 0 before each path and read after it."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    out = {}
    batches = _resil_batches(RESIL["ft_batches"], RESIL["seed"])
    with _deterministic():
        base = _resil_net(fused=True)
        out["guarded"], guarded_net = _resil_guarded(base, batches)
        out["watchdog"] = _resil_watchdog(guarded_net, batches)
        del guarded_net
        out["ft"] = _resil_ft(base, batches)
        out["ft_cost"] = _resil_ft_cost(base, batches)
        out["rollback"] = _resil_rollback(base, batches)
        del base
        torch.cuda.empty_cache()
        out["remat"] = _resil_remat(batches[:RESIL["remat_warmup"]
                                            + RESIL["remat_steps"]])
        out["vgg_layers"] = _resil_vgg_layers()
    out["ops"] = _resil_ops_runtime()
    shutil.rmtree(RESIL_DIR, ignore_errors=True)
    out["launches"] = out["guarded"]["launches"]
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[resilience] the phase {out['seconds']:.1f} s")
    return out


# -- phase 19: quant ----------------------------------------------------------
#: fine-tune, then serve int8: ResNet-50 at its published width (224×224×3,
#: 1000 classes, the resnet phase's BN draws) saved and restored as the
#: "pretrained" source; a new head (Dense 2048 → `hidden`, relu, QAT int8;
#: then a `classes`-way output) trained with everything up to res4_5_relu
#: frozen, under early stopping, on a synthetic learnable task: class c's
#: image is `signal` × its seeded pattern plus `noise` × N(0, 1). `train`
#: batches an epoch, `held` held-out batches for the loss calculator, at
#: most `epochs` epochs with a patience of `patience`; `calib` training
#: batches calibrate the int8 twin; `agree` held-out images for the top-1
#: agreement; `cpu_rows` rows through the CPU twin
QUANT = dict(size=224, batch=32, classes=10, hidden=256, train=8, held=2,
             epochs=5, patience=2, lr=0.01, seed=23, calib=2, agree=256, cpu_rows=4,
             signal=1.0, noise=0.5, ladder=[1, 2, 4, 8, 16, 32], timed=10,
             recal=1.25)
QUANT_DIR = Path(__file__).resolve().parent / "build" / "quant"
#: pairs the fusion marks in the fine-tuned net: res5's three _a, three _c
#: and one _sc conv (frozen pairs are not fused)
QUANT_PAIRS = 7
#: the int8 twin: 36 1×1 convs (BN folded) + the QAT head; the stem and
#: the 16 3×3 convs stay fp
QUANT_STATS = {"int8_layers": 37, "fallbacks": 17, "folded_bns": 36}
#: one quantized layer on the card against B6's plain version, from the
#: same input: nvcc contracts acc·scale + shift into one FMA, the plain
#: version rounds twice, so the two differ by at most an ulp of the output
INT8_LAYER_RTOL = 1e-6
#: the int8 forward on the card against the same network on the CPU
#: through the plain version, and served answers against output(): an ulp
#: of an epilogue (or of cuDNN's fp 3×3 convs against the CPU's, or
#: between algorithms of two batch sizes) can move a later layer's
#: quantized input by one int8 step, and such steps add up over 37
#: layers; softmax outputs are held to this absolute tolerance (printed
#: beside the int8 forward's own distance from the fp one) and the top-1
#: must agree
INT8_E2E_ATOL = 5e-2
#: int8 top-1 against the fp best model on the `agree` held-out images
INT8_AGREE = 0.95
#: the int8 forward's device time by group (--profile): B6's int8 route
#: and the quantize passes (x/s, round, clamp; the int8 cast is a copy)
#: ahead of the table the other phases use
QUANT_GROUPS = (("matmul_epilogue_kernel<signed char", "int8_matmul_epilogue"),
                ("matmul_epilogue_kernel<int8", "int8_matmul_epilogue"),
                ("div_true", "quantize (x/s, round, clamp)"),
                ("round_kernel", "quantize (x/s, round, clamp)"),
                ("clamp_scalar_kernel", "quantize (x/s, round, clamp)"),
                ) + KERNEL_GROUPS


def _quant_data(n, seed):
    """`n` images of the synthetic task and their one-hot labels, drawn in
    bulk: class c is QUANT["signal"] × pattern c + QUANT["noise"] ×
    N(0, 1), the patterns fixed by QUANT["seed"]."""
    k, hw = QUANT["classes"], QUANT["size"]
    patterns = np.random.default_rng(QUANT["seed"]).standard_normal(
        (k, hw, hw, 3), dtype=np.float32)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, k, n)
    x = rng.standard_normal((n, hw, hw, 3), dtype=np.float32)
    x *= QUANT["noise"]
    x += QUANT["signal"] * patterns[labels]
    return x, np.eye(k, dtype=np.float32)[labels]


class _QuantSaver(LocalFileModelSaver):
    """LocalFileModelSaver that also keeps the best model in memory (a
    clone), so the restored archive can be held against it."""

    def __init__(self, directory):
        super().__init__(directory, device=DEV)
        self.memory = InMemoryModelSaver()

    def saveBestModel(self, net, score):
        super().saveBestModel(net, score)
        self.memory.saveBestModel(net, score)


def _snapshot(tree, names=None):
    return {n: {k: v.clone() for k, v in d.items()} for n, d in tree.items()
            if names is None or n in names}


def _equal_trees(a, b):
    """The names whose tensors differ (empty: bit for bit equal)."""
    return [f"{n}/{k}" for n in a for k in a[n]
            if not torch.equal(a[n][k], b[n][k])]


def _quant_source():
    """ResNet-50 with the resnet phase's BN draws, saved and restored
    through ModelSerializer: the pretrained source."""
    QUANT_DIR.mkdir(parents=True, exist_ok=True)
    hw = QUANT["size"]
    net = ResNet50(updater=Nesterovs(0.01, 0.9),
                   inputShape=(hw, hw, 3)).init(DEV)
    _perturb_bn(net, RESNET["seed"])
    path = str(QUANT_DIR / "source.zip")
    t0 = time.perf_counter()
    ModelSerializer.writeModel(net, path)
    src = ModelSerializer.restoreComputationGraph(path, device=DEV)
    bad = _equal_trees(net._params, src._params) + _equal_trees(
        net._state, src._state)
    if bad:
        raise AssertionError(f"quant: the restored source differs: {bad[:4]}")
    log(f"[quant] source ResNet-50 saved and restored in "
        f"{time.perf_counter() - t0:.2f} s ({os.path.getsize(path)} bytes)")
    return src


def _quant_transfer(src):
    """The fine-tune network: res5 and a new QAT head trainable, the rest
    frozen, built with the fusion on."""
    ftc = (FineTuneConfiguration.Builder()
           .updater(Nesterovs(QUANT["lr"], 0.9)).build())
    head = DenseLayer(nIn=2048, nOut=QUANT["hidden"], activation="relu",
                      precisionPolicy=PrecisionPolicy.int8())
    out = OutputLayer(nIn=QUANT["hidden"], nOut=QUANT["classes"],
                      lossFunction="mcxent", activation="softmax")
    with _fusion(True):
        net = (TransferLearning.GraphBuilder(src).fineTuneConfiguration(ftc)
               .setFeatureExtractor("res4_5_relu")
               .removeVertexAndConnections("fc")
               .addLayer("head", head, "avgpool")
               .addLayer("out", out, "head")
               .setOutputs("out").build())
    if len(net._fused_pairs) != QUANT_PAIRS:
        raise AssertionError(f"quant: {len(net._fused_pairs)} fused pairs "
                             f"in the fine-tune net, expected {QUANT_PAIRS}")
    frozen = sorted(n for n, nd in net.conf.nodes.items()
                    if nd.kind == "layer" and getattr(nd.ref, "frozen",
                                                      False))
    return net, frozen


def _http_json(port, path):
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return json.loads(r.read())


def _quant_finetune(net, frozen, train, held):
    """Early stopping over the synthetic task, with a ScoreIterationListener
    and a StatsListener into a storage that a UIServer serves. Returns
    (the saver, the result, gates and numbers)."""
    saver = _QuantSaver(str(QUANT_DIR / "es"))
    train_it = ArrayDataSetIterator(*train, QUANT["batch"])
    held_it = ArrayDataSetIterator(*held, QUANT["batch"])
    cfg = (EarlyStoppingConfiguration.Builder()
           .epochTerminationConditions(
               MaxEpochsTerminationCondition(QUANT["epochs"]),
               ScoreImprovementEpochTerminationCondition(QUANT["patience"]))
           .scoreCalculator(DataSetLossCalculator(held_it, True))
           .modelSaver(saver).build())
    storage = InMemoryStatsStorage()
    # activation histograms on the first record only: a histogram of every
    # node of a B=32 ResNet-50 forward copies gigabytes to the host
    stats = StatsListener(storage, activationFrequency=10 ** 6)
    net.setListeners(ScoreIterationListener(
        QUANT["train"], log_fn=lambda s: log(f"[quant] {s}")), stats)
    ui = UIServer()
    ui.attach(storage)
    ui.start(port=0)
    try:
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        result = EarlyStoppingGraphTrainer(cfg, net, train_it).fit()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counts()
        records = _http_json(ui.port, "/stats")
    finally:
        ui.stop()
    iters = net.getIterationCount()
    out = {"epochs": result.totalEpochs, "best_epoch": result.bestModelEpoch,
           "best_score": result.bestModelScore,
           "score_vs_epoch": result.scoreVsEpoch,
           "reason": result.terminationReason,
           "details": result.terminationDetails, "iterations": iters,
           "seconds": wall, "launches": launches}
    it_ms = [r["iterationTimeMs"] for r in records
             if r.get("iterationTimeMs") is not None]
    log(f"[quant] early stopping: {result}; {iters} iterations in "
        f"{wall:.1f} s (median {float(np.median(it_ms)):.1f} ms between "
        "records, listeners and the epoch ends' scoring and saves "
        "included); held-out loss by epoch "
        + ", ".join(f"{e}: {s:.6f}" for e, s in result.scoreVsEpoch.items()))
    for k in TRAIN_KERNELS:
        if launches[k] != QUANT_PAIRS * iters:
            raise AssertionError(f"quant: {k} launched {launches[k]} times "
                                 f"in {iters} steps, expected "
                                 f"{QUANT_PAIRS} a step")
    if len(records) != iters or [r["iteration"] for r in records] != list(
            range(1, iters + 1)):
        raise AssertionError(f"quant: GET /stats gave {len(records)} "
                             f"records for {iters} iterations")
    frozen_keys = {f"{n}_" for n in frozen}
    zero, moved = 0, 0
    for r in records[1:]:
        for k, v in r["updateRatios"].items():
            is_frozen = any(k.startswith(p) for p in frozen_keys)
            if is_frozen and v != 0.0:
                raise AssertionError(f"quant: frozen {k} update ratio {v} "
                                     f"at iteration {r['iteration']}")
            if not is_frozen and not v > 0.0:
                raise AssertionError(f"quant: trained {k} update ratio {v} "
                                     f"at iteration {r['iteration']}")
            zero += is_frozen
            moved += not is_frozen
    hist = records[0].get("activationHistograms") or {}
    if not hist:
        raise AssertionError("quant: the first stats record has no "
                             "activation histograms")
    out["stats"] = {"records": len(records), "zero_ratios": zero,
                    "nonzero_ratios": moved, "histograms": len(hist)}
    log(f"[quant] GET /stats: {len(records)} records, update ratios "
        f"exactly 0 for the frozen parameters ({zero}) and > 0 for res5 "
        f"and the head ({moved}); {len(hist)} activation histograms on the "
        "first record")
    return saver, result, out


def _quantized_nodes(q):
    return [n for n in q.conf.topo_order
            if isinstance(q.nodes[n].ref, (QuantizedConv1x1,
                                           QuantizedDense))]


def _quant_vs_plain(q, best, x):
    """Each quantized layer of the card's forward against B6's plain
    version from the same input, and the whole forward against the same
    network on the CPU through the plain version (beside the int8
    forward's distance from the fp `best`'s)."""
    with torch.no_grad():
        acts = {k: v.tensor for k, v in q.feedForward(x).items()}
        worst = (-1.0, None)
        for name in _quantized_nodes(q):
            node = q.nodes[name]
            plain = copy.copy(node.ref)
            plain.impl = "dot"
            want, _ = plain.apply({k: v.cpu() for k, v in
                                   q._params[name].items()}, {},
                                  acts[node.inputs[0]].cpu())
            err = (acts[name].cpu() - want).abs().max().item() / max(
                1.0, want.abs().max().item())
            worst = max(worst, (err, name), key=lambda t: t[0])
        if worst[0] > INT8_LAYER_RTOL:
            raise AssertionError(f"quant: {worst[1]} on the card differs from"
                                 f" the plain version by {worst[0]:.3g} of "
                                 f"its largest value > {INT8_LAYER_RTOL}")
        cpu = QuantizedComputationGraph(copy.deepcopy(q.conf), "cpu")
        for name in _quantized_nodes(cpu):
            cpu.nodes[name].ref.impl = "dot"
        cpu._params = {n: {k: v.cpu() for k, v in d.items()}
                       for n, d in q._params.items()}
        cpu._state = {n: {k: v.cpu() for k, v in d.items()}
                      for n, d in q._state.items()}
        got = q.output(x).tensor.cpu()
        want = cpu.output(x).tensor
        fp = best.output(x).tensor.cpu()
    e2e = (got - want).abs().max().item()
    vs_fp = (got - fp).abs().max().item()
    if e2e > INT8_E2E_ATOL or not torch.equal(got.argmax(-1),
                                              want.argmax(-1)):
        raise AssertionError(f"quant: the int8 forward on the card differs "
                             f"from the plain version on the CPU by {e2e} "
                             f"(atol {INT8_E2E_ATOL}) or in its top-1")
    log(f"[quant] int8 forward on the card against B6's plain version: "
        f"largest per-layer difference {worst[0]:.3g} of the layer's "
        f"largest value ({worst[1]}; tol {INT8_LAYER_RTOL}); whole "
        f"forward of {x.shape[0]} rows against the CPU twin: largest "
        f"|Δ softmax| {e2e:.3g} (atol {INT8_E2E_ATOL}), top-1 equal; the "
        f"int8 forward against the fp one: {vs_fp:.3g}")
    return {"layer_rel_err": worst[0], "layer": worst[1], "e2e_abs_err": e2e,
            "int8_vs_fp_abs": vs_fp}


def _quant_serve(q, images, sizes, head_scale):
    """The requests through ParallelInference(BATCHED, batchLimit=32) with
    the bucket ladder, twice in one store: before and after a
    recalibration of the head's activation scale written in place."""
    off = np.concatenate([[0], np.cumsum(sizes)])
    pi = (ParallelInference.Builder(q).inferenceMode(InferenceMode.BATCHED)
          .batchLimit(QUANT["batch"]).bucketLadder(QUANT["ladder"]).build())

    def serve():
        answers, errs = [None] * len(sizes), []
        nxt, lock = [0], threading.Lock()

        def client():
            while True:
                with lock:
                    i = nxt[0]
                    nxt[0] += 1
                if i >= len(sizes):
                    return
                try:
                    answers[i] = pi.output(images[off[i]:off[i + 1]])
                except Exception as e:  # noqa: BLE001 — re-raised below
                    errs.append(e)
                    return
        threads = [threading.Thread(target=client)
                   for _ in range(RESNET["threads"])]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if errs or any(t.is_alive() for t in threads):
            raise AssertionError(f"quant: serving failed: {errs}")
        return answers

    def check(answers, what):
        worst = 0.0
        for i, a in enumerate(answers):
            want = q.output(images[off[i]:off[i + 1]]).tensor.cpu().numpy()
            worst = max(worst, float(np.abs(a - want).max()))
            if not np.array_equal(a.argmax(-1), want.argmax(-1)):
                raise AssertionError(f"quant: {what}: request {i}'s top-1 "
                                     "differs from output()")
        if worst > INT8_E2E_ATOL:
            raise AssertionError(f"quant: {what}: answers differ from "
                                 f"output() by {worst} > {INT8_E2E_ATOL}")
        return worst

    try:
        warm = pi.warmup()
        torch.cuda.synchronize()
        _reset_counts()
        calls = pi.model_calls
        t0 = time.perf_counter()
        first = serve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counts()
        forwards = pi.model_calls - calls
        before = pi.status()["executables"]
        err = check(first, "serving")
        recalibrate(q, {"head": head_scale * QUANT["recal"]})
        second = serve()
        after = pi.status()["executables"]
        err2 = check(second, "serving after the recalibration")
    finally:
        pi.shutdown()
    moved = max(float(np.abs(a - b).max()) for a, b in zip(first, second))
    if not moved > 0:
        raise AssertionError("quant: the recalibration changed no answer")
    for k in ("captures", "live_captures", "rebinds", "degradations"):
        if after[k] != before[k]:
            raise AssertionError(f"quant: the recalibration moved the "
                                 f"store's {k}: {before[k]} -> {after[k]}")
    if after["capture"] and after["eager_calls"]:
        raise AssertionError(f"quant: {after['eager_calls']} eager calls in "
                             "a capturing store")
    if launches["int8_matmul_epilogue"] != QUANT_STATS["int8_layers"] \
            * forwards:
        raise AssertionError(f"quant: {launches['int8_matmul_epilogue']} "
                             f"int8 launches in {forwards} served forwards")
    log(f"[quant] int8 serving: {sum(sizes)} images in {len(sizes)} "
        f"requests from {RESNET['threads']} threads through the bucket "
        f"ladder: {forwards} forwards in {wall:.3f} s "
        f"({sum(sizes) / wall:.1f} images/s), "
        f"{launches['int8_matmul_epilogue']} int8 launches; answers within "
        f"{err:.3g} of output(); after a recalibration of the head's scale "
        f"(×{QUANT['recal']}, written in place): answers moved by up to "
        f"{moved:.3g}, within {err2:.3g} of output(), captures "
        f"{before['captures']} -> {after['captures']}")
    return {"warmup": warm, "forwards": forwards, "wall_s": wall,
            "images_per_s": sum(sizes) / wall, "launches": launches,
            "max_abs_vs_output": err, "recal_moved": moved,
            "recal_max_abs_vs_output": err2, "captures": after["captures"]}


def _quant_times(best, q, x, net, batches, profile):
    """fp against int8 B=32 forwards through their graphs, in turns; the
    fine-tune step through its graph; with `profile`, the int8 forward's
    device time by group."""
    stores, keys = {}, {}
    sig = ((tuple(x.shape), "float32"),)
    for what, m in (("fp", best), ("int8", q)):
        st = ExecutableStore(m)
        st.warmup([sig])
        st.ensure(sig)[0].copy_(torch.as_tensor(x, device=DEV))
        stores[what], keys[what] = st, ("forward", sig)
    ms = {"fp": [], "int8": []}
    for what in ("fp", "int8", "int8", "fp"):
        ms[what].append(time_ms(lambda: stores[what].run(keys[what])))
    log(f"[quant] B=32 forward through its graph, in turns fp, int8, int8, "
        f"fp: fp {ms['fp'][0]:.3f}/{ms['fp'][1]:.3f} ms, int8 "
        f"{ms['int8'][0]:.3f}/{ms['int8'][1]:.3f} ms")
    net.setListeners()
    for ds in batches[:2]:
        net.fit(ds)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    for i in range(QUANT["timed"]):
        net.fit(batches[i % len(batches)])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / QUANT["timed"]
    launches = _counts()
    log(f"[quant] fine-tune step through its graph: {step_ms:.2f} ms/step "
        f"over {QUANT['timed']} steps (B=32; "
        + ", ".join(f"{k} {launches[k]}" for k in TRAIN_KERNELS) + ")")
    out = {"fp_ms": ms["fp"], "int8_ms": ms["int8"], "step_ms": step_ms,
           "step_launches": launches}
    if profile:
        out["profile"], _ = _profiled(
            "int8 ResNet-50 forward B=32 (graph, 3 replays)",
            lambda: [stores["int8"].run(keys["int8"]) for _ in range(3)],
            QUANT_GROUPS)
        out["profile_fp"], _ = _profiled(
            "fp ResNet-50 forward B=32 (graph, 3 replays)",
            lambda: [stores["fp"].run(keys["fp"]) for _ in range(3)],
            QUANT_GROUPS)
    return out


@contextlib.contextmanager
def _no_tf32():
    was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = was


def phase_quant(profile=False):
    """Fine-tune, then serve int8 (phase 19); the launch counts are set to
    0 before each path and read after it."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    q_b, n_train, n_held = QUANT["batch"], QUANT["train"], QUANT["held"]
    x, y = _quant_data(q_b * (n_train + n_held), QUANT["seed"] + 1)
    train = (x[:q_b * n_train], y[:q_b * n_train])
    held = (x[q_b * n_train:], y[q_b * n_train:])
    out = {}
    with _no_tf32():
        src = _quant_source()
        src_before = (_snapshot(src._params), _snapshot(src._state))
        net, frozen = _quant_transfer(src)
        frozen_before = (_snapshot(net._params, frozen),
                         _snapshot(net._state, frozen))
        saver, result, out["finetune"] = _quant_finetune(net, frozen, train,
                                                          held)
        bad = (_equal_trees(frozen_before[0], net._params)
               + _equal_trees(frozen_before[1], net._state))
        if bad:
            raise AssertionError(f"quant: frozen tensors moved: {bad[:4]}")
        bad = (_equal_trees(src_before[0], src._params)
               + _equal_trees(src_before[1], src._state))
        if bad:
            raise AssertionError(f"quant: the source moved: {bad[:4]}")
        log(f"[quant] {len(frozen)} frozen layers bit for bit unchanged "
            f"after {net.getIterationCount()} steps; the source equals its "
            "values before the fine-tune")
        del src, src_before
        with _fusion(True):
            best = saver.getBestModel()
        mem = saver.memory.getBestModel()
        bad = (_equal_trees(mem._params, best._params)
               + _equal_trees(mem._state, best._state))
        if bad:
            raise AssertionError(f"quant: the restored best model differs "
                                 f"from the in-memory best: {bad[:4]}")
        del mem, saver.memory
        log(f"[quant] the restored best model (epoch "
            f"{result.bestModelEpoch}) equals the in-memory best bit for "
            f"bit; {len(best._fused_pairs)} fused pairs")
        calib = [train[0][i * q_b:(i + 1) * q_b]
                 for i in range(QUANT["calib"])]
        t0 = time.perf_counter()
        q = quantize_network(best, data=calib)
        rewrite_s = time.perf_counter() - t0
        got = {k: q._quant_stats[k] for k in QUANT_STATS}
        if got != QUANT_STATS:
            raise AssertionError(f"quant: _quant_stats {got}, expected "
                                 f"{QUANT_STATS}")
        log(f"[quant] quantize_network in {rewrite_s:.2f} s: "
            f"{q._quant_stats['int8_layers']} int8 layers, "
            f"{q._quant_stats['fallbacks']} fallbacks, "
            f"{q._quant_stats['folded_bns']} folded BNs, "
            f"{q._quant_stats['chains']} chains")
        ax, ay = _quant_data(QUANT["agree"], QUANT["seed"] + 2)
        x32 = ax[:q_b]
        with torch.no_grad():
            q.output(x32)
            torch.cuda.synchronize()
            _reset_counts()
            q.output(x32)
            torch.cuda.synchronize()
            one = _counts()
        if one["int8_matmul_epilogue"] != QUANT_STATS["int8_layers"]:
            raise AssertionError(f"quant: one int8 forward launched "
                                 f"{one['int8_matmul_epilogue']} int8 "
                                 "epilogues, expected "
                                 f"{QUANT_STATS['int8_layers']}")
        out["vs_plain"] = _quant_vs_plain(q, best, ax[:QUANT["cpu_rows"]])
        with torch.no_grad():
            fp_top = torch.cat([best.output(ax[i:i + q_b]).tensor.argmax(-1)
                                for i in range(0, len(ax), q_b)])
            q_top = torch.cat([q.output(ax[i:i + q_b]).tensor.argmax(-1)
                               for i in range(0, len(ax), q_b)])
        agree = float((fp_top == q_top).float().mean())
        acc = float((q_top.cpu() == torch.as_tensor(ay.argmax(-1)))
                    .float().mean())
        fp_acc = float((fp_top.cpu() == torch.as_tensor(ay.argmax(-1)))
                       .float().mean())
        log(f"[quant] top-1 on {len(ax)} held-out images: int8 agrees with "
            f"fp on {agree:.4f} (gate {INT8_AGREE}); accuracy fp {fp_acc:.4f},"
            f" int8 {acc:.4f}")
        if agree < INT8_AGREE:
            raise AssertionError(f"quant: int8/fp top-1 agreement {agree}")
        sizes = _resnet_requests()[0]
        images = _quant_data(sum(sizes), QUANT["seed"] + 3)[0]
        head_scale = float(q._params["head"]["x_scale"])
        out["serving"] = _quant_serve(q, images, sizes, head_scale)
        out["times"] = _quant_times(best, q, x32, net,
                                    [DataSet(train[0][i * q_b:(i + 1) * q_b],
                                             train[1][i * q_b:(i + 1) * q_b])
                                     for i in range(n_train)], profile)
    out.update({"stats": got, "one_forward": one, "agree": agree,
                "accuracy_int8": acc, "accuracy_fp": fp_acc,
                "rewrite_s": rewrite_s,
                "launches": {"int8_matmul_epilogue":
                             out["serving"]["launches"][
                                 "int8_matmul_epilogue"],
                             **{k: out["finetune"]["launches"][k]
                                for k in TRAIN_KERNELS}}})
    shutil.rmtree(QUANT_DIR, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[quant] the phase {out['seconds']:.1f} s")
    return out


# -- phase 20: parallel ----------------------------------------------------------
#: the parallel phase (`--only parallel`): BERT-base's width, cut to
#: `layers` layers, in the long-context recipe of
#: examples/long_context_bert.py (T = 4096, B = 2, remat, Adam under
#: ZeRO-1, the flash ring as attn_impl) through ShardedTrainer, and fused
#: ResNet-50 through ParallelWrapper. Arm A: NCCL, one rank per card; arm
#: B: two gloo ranks on the first card (host-staged hops: each layer's
#: ring exchange is a host round trip, so the depth sets arm B's time).
PAR = dict(seq=4096, batch=2, steps=3, lr=1e-4, seed=11, layers=4,
           resnet_size=224, resnet_batch=32, resnet_steps=2, resnet_timed=5,
           ring_lengths=[4096, 2900], pipe_batch=8, pipe_seq=512,
           pipe_micro=4, bert=None,
           backend_a="nccl", deadline_a_s=420, deadline_b_s=480,
           pg_timeout_s=300)
#: gates. Ring vs flash at sp = 1 and the gloo ring at sp = 2 vs arm A:
#: each gradient leaf's L2 error relative to its norm, the losses
#: relatively; the ring and Ulysses kernels' paths against their plain
#: versions, scaled by max(1, max |plain|); the pipeline against the
#: sequential forward. ParallelWrapper's ResNet-50 at 2 × 16 rows (synced
#: BN) against one rank's net.fit on the 32 rows, both through their fit:
#: - the unfused net in f64, 2 steps: each leaf's update (parameters minus
#:   the start) and each BN running statistic after each step within
#:   PAR_RESNET_F64_RTOL of one rank's, L2 relative to its norm (the CPU,
#:   64×64 at 2 × 8 rows: 1.4e-12 after 2 steps; a rank that sums only
#:   its own rows is off by percents);
#: - the fused net in f32 (B5, B7, B8 with their sums over dp): the losses
#:   of 2 steps relatively (step 2 follows one update), and step 1's update
#:   held to the f64 one as the resnet_train phase holds the fused
#:   gradients (the update is −(1 + μ)·lr·g at the first Nesterov step):
#:   each leaf's max|err|/max|f64| within max(RESNET_GRAD_RTOL,
#:   RESNET_GRAD_FACTOR × one rank's, one rank's worst leaf), the median
#:   within RESNET_GRAD_FACTOR × one rank's. (Two sound f32 runs of this
#:   net differ by ~2 % at the median leaf of one step's gradients, and by
#:   up to 2.03× at a leaf: the resnet_train phase's fused/unfused ratio.
#:   Two steps in f32 are printed beside the same spread of two sound
#:   one-rank runs, fused and unfused, and not gated: each step's 2 %
#:   carries through BN into the next.)
PAR_GRAD_RTOL = 1e-3
PAR_LOSS_RTOL = 1e-5
PAR_ATTN_ATOL = 1e-4
PAR_PIPE_ATOL = 1e-4
PAR_RESNET_LOSS_RTOL = (1e-4, 1e-3)
PAR_RESNET_F64_RTOL = 1e-9
PAR_DIR = Path(__file__).resolve().parent / "build" / "parallel"
PAR_BERT_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def _par_sync():
    if DEV == "cuda":
        torch.cuda.synchronize()


def _par_reset_peak():
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()


def _par_peak():
    return torch.cuda.max_memory_allocated() if DEV == "cuda" else None


def _par_launched(counts, kernels):
    """Every kernel of the path launched (the plain versions of a CPU
    rehearsal count none)."""
    return DEV != "cuda" or all(counts[k] > 0 for k in kernels)


def _par_cfg():
    over = dict(max_position_embeddings=PAR["seq"], remat=True)
    if PAR["bert"]:
        from deeplearning4j_tpu_torch.models import bert_tiny
        return bert_tiny(**over, **PAR["bert"])
    return bert_base(num_layers=PAR["layers"], **over)


def _par_batch(cfg):
    rng = np.random.default_rng(PAR["seed"])
    return {"input_ids": rng.integers(0, cfg.vocab_size,
                                      (PAR["batch"], PAR["seq"])),
            "labels": rng.integers(0, cfg.num_labels, (PAR["batch"],))}


def _par_trainer(cfg, mesh, attn):
    """ShardedTrainer over the recipe's loss: the ring (a shard_map of
    make_ring_attention over sp: the flash ring on the card) or "flash"."""
    from deeplearning4j_tpu_torch.models.bert import sharding_rules
    from deeplearning4j_tpu_torch.parallel import (ShardedTrainer,
                                                   make_ring_attention)
    from deeplearning4j_tpu_torch.parallel.mesh import P, shard_map
    impl = attn
    if attn == "ring":
        spec = P(None, None, "sp", None)
        impl = shard_map(make_ring_attention(mesh, "sp"), mesh=mesh,
                         in_specs=(spec, spec, spec), out_specs=spec)

    def loss_fn(p, batch, generator):
        return classification_loss(cfg, p, batch, train=False,
                                   attn_impl=impl)

    return ShardedTrainer(loss_fn, Adam(PAR["lr"]), mesh,
                          sharding_rules(cfg, mesh, dp="dp", tp=None))


def _par_grads(tr, p, b):
    """(loss, {path: gradient}) of one dp-synced backward of `tr`."""
    from deeplearning4j_tpu_torch.parallel.sharded_trainer import \
        accumulate_grads
    grads, loss, _ = accumulate_grads(tr._gathered_loss, p, b, None, 1)
    grads, loss = tr._sync(dict(grads), loss)
    return float(loss), grads


def _par_leaf_rel(got, want):
    """{path: ‖got − want‖ / ‖want‖} (0 where both are 0)."""
    out = {}
    for k, w in want.items():
        a, w = got[k].double().cpu(), w.double().cpu()
        n = float(w.norm())
        d = float((a - w).norm())
        out[k] = 0.0 if d == 0 else d / max(n, 1e-30)
    return out


def _par_bert_run(tr, cfg, params, batch, steps):
    """Init (ZeRO-1 state), one synced backward, then `steps` timed steps
    with the kernel counts set to 0 just before them."""
    from deeplearning4j_tpu_torch.parallel.zero import shard_optimizer_state
    from deeplearning4j_tpu_torch.parallel.sharded_trainer import _paths
    p, s = tr.init(params)
    s = shard_optimizer_state(s, tr.mesh, axis="dp")
    b = tr.shard_batch(batch)
    loss, grads = _par_grads(tr, p, b)
    _par_sync()
    _par_reset_peak()
    _reset_counts()
    losses, ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        p, s, step_loss = tr.fit_batch(p, s, b, None)
        losses.append(float(step_loss))
        _par_sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    counts = _counts()
    return dict(loss=loss, grads=grads, losses=losses, ms=ms,
                counts=counts, peak=_par_peak(),
                params=dict(_paths(p)))


def _par_resnet_net(fused=True):
    with _fusion(fused):
        net = ResNet50(inputShape=(PAR["resnet_size"],) * 2 + (3,),
                       updater=Nesterovs(0.01, 0.9)).init(DEV)
    _perturb_bn(net, RESNET["seed"])
    return net


def _par_resnet_batch(rows=None):
    rng = np.random.default_rng(PAR["seed"] + 1)
    b, hw = PAR["resnet_batch"], PAR["resnet_size"]
    x = rng.standard_normal((b, hw, hw, 3), dtype=np.float32)
    y = np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, b)]
    return DataSet(x, y)


def _par_tree(tree):
    return {f"{n}/{k}": v.detach().cpu().clone() for n in sorted(tree)
            for k, v in sorted(tree[n].items())}


def _par_equal(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


def _par_arm_a(world, rank):
    """NCCL, one rank per card: the recipe through the flash ring against
    the same trainer with attn_impl="flash"; ParallelWrapper's graphed
    fused ResNet-50 step against net.fit's and its own eager step."""
    from deeplearning4j_tpu_torch.parallel import DeviceMesh, ParallelWrapper
    out = {}
    mesh = DeviceMesh(dp=1, sp=world)
    cfg = _par_cfg()
    params = init_bert_params(cfg, 0, device=DEV)
    batch = _par_batch(cfg)
    ring = _par_bert_run(_par_trainer(cfg, mesh, "ring"), cfg, params,
                         batch, PAR["steps"])
    flash = _par_bert_run(_par_trainer(cfg, mesh, "flash"), cfg, params,
                          batch, PAR["steps"])
    g_err = _par_leaf_rel(ring["grads"], flash["grads"])
    p_err = _par_leaf_rel(ring["params"], flash["params"])
    out["bert"] = dict(
        loss=ring["loss"], flash_loss=flash["loss"],
        grad_rel_worst=max(g_err.values()),
        grad_rel_median=float(np.median(list(g_err.values()))),
        losses=ring["losses"], flash_losses=flash["losses"],
        params_rel_worst=max(p_err.values()), ms=ring["ms"],
        flash_ms=flash["ms"], peak_bytes=ring["peak"],
        flash_peak_bytes=flash["peak"], launches=ring["counts"],
        flash_launches=flash["counts"])
    if rank == 0:
        torch.save({"loss": ring["loss"], "losses": ring["losses"],
                    "grads": {k: v.cpu() for k, v in ring["grads"].items()},
                    "params": {k: v.cpu()
                               for k, v in ring["params"].items()}},
                   PAR_DIR / "bert_ref.pt")
    del ring, flash, params
    torch.cuda.empty_cache()
    with _deterministic():
        ds = _par_resnet_batch()
        ref, net, eager = (_par_resnet_net(), _par_resnet_net(),
                           _par_resnet_net())
        init = _par_tree(net._params)
        pw = ParallelWrapper.Builder(net).workers(world).build()
        pw_e = ParallelWrapper.Builder(eager).workers(world).cudaGraphs(
            False).build()
        same_fit, same_eager, losses, steps = [], [], [], []
        for _ in range(PAR["resnet_steps"]):
            ref.fit(ds)
            steps.append(_par_tree(ref._params))
            pw.fit([ds])
            pw_e.fit([ds])
            _par_sync()
            losses.append(float(net._score))
            same_fit.append(_par_equal(_par_tree(ref._params),
                                       _par_tree(net._params))
                            and _par_equal(_par_tree(ref._state),
                                           _par_tree(net._state)))
            same_eager.append(_par_equal(_par_tree(eager._params),
                                         _par_tree(net._params))
                              and _par_equal(_par_tree(eager._state),
                                             _par_tree(net._state)))
        del ref, eager
        if rank == 0:
            torch.save({"init": init, "steps": steps,
                        "state": _par_tree(net._state), "losses": losses,
                        **_par_resnet_refs(ds)},
                       PAR_DIR / "resnet_ref.pt")
        _par_sync()
        _par_reset_peak()
        _reset_counts()
        t0 = time.perf_counter()
        for _ in range(PAR["resnet_timed"]):
            pw.fit([ds])
        _par_sync()
        ms = (time.perf_counter() - t0) * 1e3 / PAR["resnet_timed"]
        counts = _counts()
        st = net.fit_status() or {}
    out["resnet"] = dict(
        bit_equal_fit=same_fit, bit_equal_eager=same_eager, losses=losses,
        ms=ms, peak_bytes=_par_peak(),
        launches=counts, steps=PAR["resnet_timed"], store=_par_store(st),
        backend=mesh.backend("sp"))
    return out


def _par_store(st):
    """The fit store's entries (key, graph or eager) with its capture and
    replay counts; `dp_in_graph`: the data-parallel step's key (its
    function all-reduces the gradients) runs as a captured graph."""
    entries = [{"key": e["key"], "mode": e["mode"]}
               for e in st.get("entries", [])]
    return {"entries": entries,
            "captures": st.get("captures"), "replays": st.get("replays"),
            "degraded": st.get("degraded", {}),
            "dp_in_graph": any(e["key"].startswith("('dp_fit'")
                               and e["mode"] == "graph" for e in entries)}


def _par_attn_checks(world):
    """The causal and the masked flash ring against the plain ring, and
    Ulysses with flash_attention as attn_fn against single-device flash, at
    the recipe's attention shape: forward and gradients."""
    from deeplearning4j_tpu_torch.kernels.flash_attention import \
        flash_attention
    from deeplearning4j_tpu_torch.parallel import (DeviceMesh,
                                                   make_ring_attention,
                                                   ulysses_attention_sharded)
    from deeplearning4j_tpu_torch.parallel.mesh import P, shard_map
    cfg = _par_cfg()
    mesh = DeviceMesh(sp=world)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(PAR["seed"] + 2)
    shape = (PAR["batch"], cfg.num_heads, PAR["seq"], cfg.head_dim)
    q, k, v, g = (torch.randn(shape, generator=gen, device=DEV)
                  for _ in range(4))
    mask = _ragged_mask(PAR["ring_lengths"], PAR["seq"], torch.device(DEV))
    spec = P(None, None, "sp", None)
    out = {}

    def run(fn, *extra):
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        o = fn(qq, kk, vv, *extra)
        grads = torch.autograd.grad(o, (qq, kk, vv), g)
        return [o.detach()] + list(grads)

    def err(got, want):
        return max(((a - b).abs().max() / b.abs().max().clamp_min(1.0)).item()
                   for a, b in zip(got, want))

    for name, causal, masked in (("causal", True, False),
                                 ("masked", False, True)):
        specs = (spec,) * 3 + ((P(None, "sp"),) if masked else ())
        extra = (mask,) if masked else ()
        fns = [shard_map(make_ring_attention(mesh, "sp", causal=causal,
                                             use_flash=use),
                         mesh=mesh, in_specs=specs, out_specs=spec)
               for use in (True, False)]
        _reset_counts()
        got = run(fns[0], *extra)
        counts = _counts()
        want = run(fns[1], *extra)
        if masked:   # rows of padded queries attend over nothing useful
            keep = mask[:, None, :, None]
            got = [got[0] * keep] + got[1:]
            want = [want[0] * keep] + want[1:]
        out[f"ring_{name}"] = dict(err=err(got, want), launches=counts)
    _reset_counts()
    got = run(lambda a, b, c, m: ulysses_attention_sharded(
        mesh, a, b, c, mask=m, attn_fn=flash_attention), mask)
    counts = _counts()
    want = run(lambda a, b, c, m: flash_attention(a, b, c, kv_mask=m), mask)
    out["ulysses_flash"] = dict(err=err(got, want), launches=counts)
    return out


def _par_pipeline(world):
    """The recipe's layers as `world` stages of a GPipe pipeline (flash
    attention), PAR["pipe_micro"] microbatches, against the sequential
    forward."""
    from deeplearning4j_tpu_torch.models.bert import _encoder_layer
    from deeplearning4j_tpu_torch.parallel import (DeviceMesh,
                                                   make_pipeline_fn,
                                                   stack_stage_params)
    cfg = _par_cfg()
    params = init_bert_params(cfg, 1, device=DEV)
    per = cfg.num_layers // world
    stages = [{"layers": params["layers"][s * per:(s + 1) * per]}
              for s in range(world)]
    stacked = stack_stage_params(stages)

    def stage_fn(p, x):
        for layer in p["layers"]:
            x = _encoder_layer(cfg, layer, x, None, "flash")
        return x

    mesh = DeviceMesh(pp=world)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(PAR["seed"] + 3)
    x = torch.randn((PAR["pipe_batch"], PAR["pipe_seq"], cfg.hidden_size),
                    generator=gen, device=DEV)
    pipe = make_pipeline_fn(stage_fn, mesh, PAR["pipe_micro"])
    with torch.no_grad():
        _reset_counts()
        _par_sync()
        t0 = time.perf_counter()
        y = pipe(stacked, x)
        _par_sync()
        ms = (time.perf_counter() - t0) * 1e3
        counts = _counts()
        want = x
        for layer in params["layers"]:
            want = _encoder_layer(cfg, layer, want, None, "flash")
    e = ((y - want).abs().max() / want.abs().max().clamp_min(1.0)).item()
    return dict(err=e, ms=ms, launches=counts, stages=world,
                microbatches=PAR["pipe_micro"])


def _par_arm_b(world, rank):
    """Two gloo ranks on one card: the recipe at dp = 1, sp = 2 against arm
    A's sp = 1; the causal and masked flash rings and Ulysses; ParallelWrapper
    on fused ResNet-50 at 2 × 16 rows against one rank on 32; the
    pipeline."""
    from deeplearning4j_tpu_torch.parallel import DeviceMesh, ParallelWrapper
    out = {}
    mesh = DeviceMesh(dp=1, sp=world)
    cfg = _par_cfg()
    params = init_bert_params(cfg, 0, device=DEV)
    ring = _par_bert_run(_par_trainer(cfg, mesh, "ring"), cfg, params,
                         _par_batch(cfg), PAR["steps"])
    ref = torch.load(PAR_DIR / "bert_ref.pt")
    g_err = _par_leaf_rel(ring["grads"], ref["grads"])
    p_err = _par_leaf_rel(ring["params"], ref["params"])
    out["bert"] = dict(
        loss=ring["loss"], ref_loss=ref["loss"],
        grad_rel_worst=max(g_err.values()),
        grad_rel_median=float(np.median(list(g_err.values()))),
        losses=ring["losses"], ref_losses=ref["losses"],
        params_rel_worst=max(p_err.values()), ms=ring["ms"],
        peak_bytes=ring["peak"], launches=ring["counts"],
        launches_per_step={k: v / PAR["steps"]
                           for k, v in ring["counts"].items()})
    del ring, ref, params
    torch.cuda.empty_cache()
    out["attention"] = _par_attn_checks(world)
    torch.cuda.empty_cache()
    with _deterministic():
        full = _par_resnet_batch()
        ref = torch.load(PAR_DIR / "resnet_ref.pt")
        net = _par_resnet_net()
        pw = ParallelWrapper.Builder(net).workers(world).build()
        losses, trees, ms = [], [], []
        _par_sync()
        _par_reset_peak()
        _reset_counts()
        for _ in range(PAR["resnet_steps"]):
            t0 = time.perf_counter()
            pw.fit([full])      # each rank takes its 16 rows
            losses.append(float(net._score))
            _par_sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            trees.append(_par_tree(net._params))
        counts = _counts()
        peak = _par_peak()
        state = _par_tree(net._state)
        del net, pw
        torch.cuda.empty_cache()
        # the same wrapper steps on the unfused net in f64
        net = _in_f64(_par_resnet_net(fused=False))
        pw = ParallelWrapper.Builder(net).workers(world).build()
        trees64 = []
        for _ in range(PAR["resnet_steps"]):
            pw.fit([full])
            trees64.append(_par_tree(net._params))
        state64 = _par_tree(net._state)
        del net, pw
    # ms: the last step's (the first pays the first call's set-up)
    out["resnet"] = dict(
        losses=losses, ref_losses=ref["losses"], ms=ms[-1], ms_steps=ms,
        peak_bytes=peak,
        launches=counts,
        launches_per_step={k: v / PAR["resnet_steps"]
                           for k, v in counts.items()},
        **_par_resnet_compare(ref, trees, state, trees64, state64))
    del ref
    torch.cuda.empty_cache()
    out["pipeline"] = _par_pipeline(world)
    return out


def _par_resnet_refs(ds):
    """One rank's net.fit on the 32 rows that arm B's wrapper steps are held
    to: the unfused net in f64 (its parameters at the start and after each
    step, and its BN state) and in f32 (its parameters after the last step:
    the spread of two sound f32 runs beside the fused net's)."""
    out = {}
    for tag in ("f64", "unfused"):
        net = _par_resnet_net(fused=False)
        if tag == "f64":
            net = _in_f64(net)
        trees = [_par_tree(net._params)]
        for _ in range(PAR["resnet_steps"]):
            net.fit(ds)
            if tag == "f64":
                trees.append(_par_tree(net._params))
        out[tag] = trees if tag == "f64" else _par_tree(net._params)
        if tag == "f64":
            out["f64_state"] = _par_tree(net._state)
        del net
        torch.cuda.empty_cache()
    return out


def _par_flat_errors(got, want):
    """{leaf: max |got − want| / max |want|} in f64 (`_leaf_errors` over
    flat trees)."""
    return {k: ((got[k].double() - w.double()).abs().max()
                / w.double().abs().max().clamp_min(1e-300)).item()
            for k, w in want.items()}


def _par_resnet_compare(ref, trees, state, trees64, state64):
    """Arm B's wrapper runs against one rank's (`ref`, from arm A): the f64
    updates and BN state after each step (gated), step 1's f32 update
    against f64's as one rank's is (gated), and 2 steps in f32 beside two
    sound one-rank runs (printed)."""
    f64, init = ref["f64"], ref["init"]

    def update(tree, start):
        return {k: tree[k].double() - start[k].double() for k in start}

    f64_err = [max(_par_leaf_rel(update(t, f64[0]),
                                 update(f64[s + 1], f64[0])).values())
               for s, t in enumerate(trees64)]
    f64_state = max(_par_leaf_rel(state64, ref["f64_state"]).values())
    exact = update(f64[1], f64[0])
    e2 = _par_flat_errors(update(trees[0], init), exact)
    e1 = _par_flat_errors(update(ref["steps"][0], init), exact)
    worst1, med1 = max(e1.values()), float(np.median(list(e1.values())))
    med2 = float(np.median(list(e2.values())))
    bad = [f"{k} ({e2[k]:.2e} vs one rank {e1[k]:.2e})" for k in e2
           if not e2[k] <= max(RESNET_GRAD_RTOL, RESNET_GRAD_FACTOR * e1[k],
                               worst1)]
    if not med2 <= RESNET_GRAD_FACTOR * med1:
        bad.append(f"median {med2:.2e} vs one rank {med1:.2e}")
    two = _par_leaf_rel(update(trees[-1], init),
                        update(ref["steps"][-1], init))
    sound = _par_leaf_rel(update(ref["unfused"], init),
                          update(ref["steps"][-1], init))
    return dict(
        f64_update_rel_worst=f64_err, f64_state_rel_worst=f64_state,
        step1=dict(two_worst=max(e2.values()), two_median=med2,
                   one_worst=worst1, one_median=med1, bad=bad),
        update_rel_median=float(np.median(list(two.values()))),
        update_rel_worst=max(two.values()),
        sound_rel_median=float(np.median(list(sound.values()))),
        sound_rel_worst=max(sound.values()),
        state_rel_worst=max(_par_leaf_rel(state, ref["state"]).values()))


def _par_rank(rank, world, arm, init_file, knobs):
    """One rank of an arm: brings up its process group (every group with a
    timeout), runs the arm and writes its results as JSON; the parent
    reads them. The ranks load the kernels the parent built."""
    import datetime
    import traceback
    import torch.distributed as dist
    global DEV
    DEV = knobs["DEV"]
    PAR.update(knobs["PAR"])
    _child_timeline(f"parallel_{arm}{rank}", knobs.get("t0"), (
        "init_bert_params", "_par_bert_run", "_par_resnet_net",
        "_par_attn_checks", "_par_pipeline", "_par_resnet_refs"))
    res = {"rank": rank, "arm": arm}
    try:
        cuda = DEV == "cuda"
        if cuda:
            torch.cuda.set_device(rank if arm == "A" else 0)
        backend = PAR["backend_a"] if arm == "A" else "gloo"
        kw = {}
        if backend == "nccl":
            kw["device_id"] = torch.device("cuda", rank)
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=PAR["pg_timeout_s"]), **kw)
        res.update(_par_arm_a(world, rank) if arm == "A"
                   else _par_arm_b(world, rank))
        res["nvcc_runs"] = _build.nvcc_runs
        dist.barrier()
    except Exception:
        res["error"] = traceback.format_exc()
    finally:
        (PAR_DIR / f"{arm}.{rank}.json").write_text(json.dumps(res,
                                                               default=str))
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _par_spawn(arm, world, deadline_s):
    """Start `world` rank processes, join each against a deadline; a rank
    that fails or outlives the deadline fails the phase (its siblings are
    killed). Returns each rank's results."""
    import torch.multiprocessing as mp
    init = PAR_DIR / f"{arm}.init"
    if init.exists():
        init.unlink()
    for r in range(world):
        p = PAR_DIR / f"{arm}.{r}.json"
        if p.exists():
            p.unlink()
    knobs = {"DEV": DEV, "PAR": dict(PAR),
             "t0": _TIMELINE[1] if _TIMELINE else None}
    ctx = mp.start_processes(_par_rank, args=(world, arm, str(init), knobs),
                             nprocs=world, join=False, start_method="spawn")
    t0 = time.perf_counter()
    try:
        while not ctx.join(timeout=2):
            if time.perf_counter() - t0 > deadline_s:
                raise AssertionError(f"parallel arm {arm}: a rank passed its "
                                     f"{deadline_s} s deadline")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)
    seconds = time.perf_counter() - t0
    results = []
    for r in range(world):
        res = json.loads((PAR_DIR / f"{arm}.{r}.json").read_text())
        if "error" in res:
            raise AssertionError(f"parallel arm {arm} rank {r}:\n"
                                 f"{res['error']}")
        if res["nvcc_runs"]:
            raise AssertionError(f"parallel arm {arm} rank {r} compiled "
                                 f"{res['nvcc_runs']} kernels")
        results.append(res)
    return results, seconds


def _par_gate(ok, what):
    if not ok:
        raise AssertionError(f"parallel: {what}")


def _par_rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def phase_parallel():
    """Arm A (NCCL, one rank per card) and arm B (two gloo ranks on the
    first card, host-staged); every rank's kernel launches come back to
    the parent."""
    PAR_DIR.mkdir(parents=True, exist_ok=True)
    gc.collect()
    torch.cuda.empty_cache()
    world = torch.cuda.device_count() if DEV == "cuda" else 1
    a, a_s = _par_spawn("A", world, PAR["deadline_a_s"])
    b, b_s = _par_spawn("B", 2, PAR["deadline_b_s"])
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "smoke_parallel_ranks.json").write_text(json.dumps(
        {"arm_a": a, "arm_b": b}, indent=1, default=str))
    a0, b0 = a[0], b[0]
    store = a0["resnet"]["store"]
    log(f"[parallel] arm A: NCCL, {world} rank(s); arm B: 2 gloo ranks on "
        f"one card (host-staged hops: its times are not NCCL times)")
    for tag, r in (("A", a0), ("B", b0)):
        bert = r["bert"]
        log(f"[parallel] arm {tag} BERT-base width x {PAR['layers']} layers "
            f"T={PAR['seq']} B={PAR['batch']} "
            f"remat ZeRO-1 Adam, flash ring: ms/step "
            f"{[round(x, 2) for x in bert['ms']]} peak "
            f"{bert['peak_bytes']} B; loss {bert['loss']:.6f}; gradients "
            f"vs {'flash' if tag == 'A' else 'arm A'}: worst leaf "
            f"{bert['grad_rel_worst']:.3e}, median "
            f"{bert['grad_rel_median']:.3e}; launches per rank per step "
            + ", ".join(f"{k} {bert['launches'][k] / PAR['steps']:g}"
                        for k in PAR_BERT_KERNELS))
    log(f"[parallel] arm A flash trainer ms/step "
        f"{[round(x, 2) for x in a0['bert']['flash_ms']]} peak "
        f"{a0['bert']['flash_peak_bytes']} B")
    for tag, r in (("A", a0), ("B", b0)):
        rn = r["resnet"]
        log(f"[parallel] arm {tag} ParallelWrapper fused ResNet-50 "
            + (f"B={PAR['resnet_batch']} graphed" if tag == "A" else
               f"2 x {PAR['resnet_batch'] // 2} rows, synced BN, eager "
               f"(steps {[round(x, 2) for x in rn['ms_steps']]} ms)")
            + f": ms/step {rn['ms']:.2f} peak {rn['peak_bytes']} B; "
            f"launches per step "
            + ", ".join(f"{k} {rn['launches'][k] / (PAR['resnet_timed'] if tag == 'A' else PAR['resnet_steps']):g}"
                        for k in TRAIN_KERNELS))
    rn = a0["resnet"]
    log(f"[parallel] arm A wrapper vs net.fit bit-equal {rn['bit_equal_fit']}"
        f", graphed vs eager bit-equal {rn['bit_equal_eager']}; the "
        f"{rn['backend']} all-reduce inside the step's CUDA graph: "
        f"{store['dp_in_graph']} (entries {store['entries']}, captures "
        f"{store['captures']}, replays {store['replays']}, degraded "
        f"{store['degraded']})")
    rb = b0["resnet"]
    g = rb["step1"]
    log(f"[parallel] arm B ResNet-50 2 ranks vs 1 through their fit: "
        f"unfused f64, the update's L2 error per leaf, worst after each "
        f"step {rb['f64_update_rel_worst']} (rtol {PAR_RESNET_F64_RTOL:g}), "
        f"BN state worst {rb['f64_state_rel_worst']:.3e}; fused f32 losses "
        f"{rb['losses']} vs {rb['ref_losses']}; step 1's update against "
        f"f64 (max|err|/max|f64| per leaf): 2 ranks worst "
        f"{g['two_worst']:.3e} median {g['two_median']:.3e}, one rank worst "
        f"{g['one_worst']:.3e} median {g['one_median']:.3e}; failing "
        f"{g['bad']}")
    log(f"[parallel] arm B ResNet-50 f32 after 2 steps (printed, not gated): "
        f"2 ranks fused vs 1 rank fused, the update's L2 error per leaf "
        f"median {rb['update_rel_median']:.3e} worst "
        f"{rb['update_rel_worst']:.3e}; two sound one-rank runs (unfused vs "
        f"fused) median {rb['sound_rel_median']:.3e} worst "
        f"{rb['sound_rel_worst']:.3e}; BN state worst "
        f"{rb['state_rel_worst']:.3e}")
    for name, row in b0["attention"].items():
        log(f"[parallel] arm B {name}: max err {row['err']:.3e} (atol "
            f"{PAR_ATTN_ATOL:g}); launches "
            + ", ".join(f"{k} {row['launches'][k]}"
                        for k in PAR_BERT_KERNELS))
    pipe = b0["pipeline"]
    log(f"[parallel] arm B pipeline {pipe['stages']} stages x "
        f"{pipe['microbatches']} microbatches: max err {pipe['err']:.3e}, "
        f"{pipe['ms']:.1f} ms, flash_fwd {pipe['launches']['flash_fwd']}")
    log(f"[parallel] arm A {a_s:.1f} s, arm B {b_s:.1f} s (process start, "
        "imports and kernel loads included)")
    for r in a:
        bert, rn = r["bert"], r["resnet"]
        _par_gate(bert["grad_rel_worst"] <= PAR_GRAD_RTOL,
                  f"arm A ring vs flash gradients {bert['grad_rel_worst']}")
        _par_gate(all(_par_rel(x, y) <= PAR_LOSS_RTOL for x, y in zip(
            bert["losses"] + [bert["loss"]],
            bert["flash_losses"] + [bert["flash_loss"]])),
            f"arm A ring vs flash losses {bert['losses']} "
            f"{bert['flash_losses']}")
        _par_gate(_par_launched(bert["launches"], PAR_BERT_KERNELS),
                  f"arm A ring steps launched {bert['launches']}")
        _par_gate(all(rn["bit_equal_fit"]) and all(rn["bit_equal_eager"]),
                  f"arm A wrapper step not bit-equal: fit "
                  f"{rn['bit_equal_fit']} eager {rn['bit_equal_eager']}")
        _par_gate(_par_launched(rn["launches"], TRAIN_KERNELS),
                  f"arm A wrapper steps launched {rn['launches']}")
        _par_gate(DEV != "cuda" or rn["store"]["dp_in_graph"],
                  f"arm A wrapper step not captured: {rn['store']}")
    for r in b:
        bert, att, rn, pipe = (r["bert"], r["attention"], r["resnet"],
                               r["pipeline"])
        _par_gate(bert["grad_rel_worst"] <= PAR_GRAD_RTOL,
                  f"arm B sp=2 vs arm A gradients {bert['grad_rel_worst']}")
        _par_gate(all(_par_rel(x, y) <= PAR_LOSS_RTOL for x, y in zip(
            bert["losses"] + [bert["loss"]],
            bert["ref_losses"] + [bert["ref_loss"]])),
            f"arm B losses {bert['losses']} vs {bert['ref_losses']}")
        _par_gate(_par_launched(bert["launches"], PAR_BERT_KERNELS),
                  f"arm B ring steps launched {bert['launches']}")
        for name, row in att.items():
            _par_gate(row["err"] <= PAR_ATTN_ATOL,
                      f"arm B {name} error {row['err']}")
        _par_gate(all(_par_rel(x, y) <= tol for x, y, tol in zip(
            rn["losses"], rn["ref_losses"], PAR_RESNET_LOSS_RTOL)),
            f"arm B ResNet-50 losses {rn['losses']} vs {rn['ref_losses']}")
        _par_gate(max(rn["f64_update_rel_worst"]
                      + [rn["f64_state_rel_worst"]]) <= PAR_RESNET_F64_RTOL,
                  f"arm B ResNet-50 f64 2 ranks vs 1: updates "
                  f"{rn['f64_update_rel_worst']} state "
                  f"{rn['f64_state_rel_worst']}")
        _par_gate(not rn["step1"]["bad"],
                  f"arm B ResNet-50 step 1 against f64: "
                  f"{rn['step1']['bad']}")
        _par_gate(_par_launched(rn["launches"], TRAIN_KERNELS),
                  f"arm B wrapper steps launched {rn['launches']}")
        _par_gate(pipe["err"] <= PAR_PIPE_ATOL,
                  f"arm B pipeline error {pipe['err']}")
    # the main paths' launches: every rank's BERT ring steps and ResNet-50
    # wrapper steps, both arms
    launches = {k.__name__: 0 for k in KERNELS}
    for r in a + b:
        for part in ("bert", "resnet"):
            for k, v in r[part]["launches"].items():
                launches[k] += v
    return {"arm_a": a, "arm_b": b, "arm_a_s": a_s, "arm_b_s": b_s,
            "world": world, "launches": launches}


# -- phase 21: multihost --------------------------------------------------------
#: the multihost phase (`--only multihost`): BERT-base fine-tuning (the train
#: phase's batch: B = 32, T = 128, ragged padding, dropout 0.1, Adam 2e-5,
#: attn_impl="flash") through MultiHostTrainer (accumulation 2, 4 buckets,
#: threshold-encoded) under MultiHostRunner, a PeerCoordinator on a loopback
#: TCPStore and a CoordinatedGuardian, in rank processes the phase spawns.
#: Arm A: NCCL, one rank, BERT-base width cut to `a_layers` layers. Arm B:
#: two gloo ranks on the first card (host-staged), BERT-base width cut to
#: `b_layers` layers. The arms share nothing, so arm A's two processes
#: (run, then resume) and arm B's two pairs (b1, then b2) run side by side.
MH = dict(batch=32, seq=128, lr=2e-5, accum=2, buckets=4, steps=4,
          a_layers=4, save_every=2, preempt_at=2, timed=3, seed=7,
          peer_timeout=60.0,
          b_layers=2, b_batch=16, b_steps=4, b_preempt_at=2, b_leave_at=2,
          b_total=8, b_save_every=4, b_die_at=2, b_peer_timeout=10.0,
          bert=None,
          backend_a="nccl", deadline_a_s=360, deadline_b_s=360,
          pg_timeout_s=120)
MH_DIR = Path(__file__).resolve().parent / "build" / "multihost"
#: die@R: the survivor's PeerLostError comes within the peer timeout plus
#: this slack (the heartbeat wait is the peer timeout; the slack covers the
#: report and the step's own host work)
MH_LOST_SLACK_S = 5.0
#: residual mass per bucket: |(sent + r1) − (g + r0)| ≤ MH_MASS_RTOL ·
#: max|g + r0| (the new residual is one f32 subtraction, acc − sent)
MH_MASS_RTOL = 1e-6


def _mh_cfg(layers=None):
    """Arm A's model, or BERT-base's width at `layers` layers."""
    if MH["bert"]:
        from deeplearning4j_tpu_torch.models import bert_tiny
        return bert_tiny(**MH["bert"])
    return bert_base(num_layers=layers or MH["a_layers"])


def _mh_batch(cfg, step, rows, g):
    """Step `step`'s super-batch (G, rows, T), or (rows, T) at G = 1:
    seeded ids and labels, ragged lengths in [T/2, T]."""
    rng = np.random.default_rng(MH["seed"] * 1000 + step)
    t = MH["seq"]
    lens = rng.integers(t // 2, t + 1, (g, rows))
    out = {"input_ids": rng.integers(0, cfg.vocab_size, (g, rows, t)),
           "labels": rng.integers(0, cfg.num_labels, (g, rows)),
           "attention_mask": (np.arange(t)[None, None, :]
                              < lens[..., None]).astype(np.float32)}
    return {k: v[0] for k, v in out.items()} if g == 1 else out


def _mh_loss(cfg):
    def loss_fn(p, batch, gen):
        return classification_loss(cfg, p, batch, train=True, generator=gen,
                                   attn_impl="flash")
    return loss_fn


def _mh_digest(tree):
    """{path: crc32 of the leaf's bytes} of a state tree (integrity's
    checksum, as the manifests hold it)."""
    from deeplearning4j_tpu_torch.resilience.integrity import (
        _leaf_checksum, flatten)
    return {path: _leaf_checksum(leaf) for path, leaf in flatten(tree)}


def _mh_unequal(a, b):
    """Paths of two live trees whose leaves differ in any bit."""
    from deeplearning4j_tpu_torch.resilience.integrity import flatten
    fb = dict(flatten(b))
    return sorted(k for k, v in flatten(a) if not torch.equal(v, fb[k]))


def _mh_runner(directory, ns, trainer, peer_timeout, guardian=True, **kw):
    """A MultiHostRunner over a fresh PeerCoordinator (sync every step) on
    the store `multihost.initialize` brought up, namespace `ns`."""
    from deeplearning4j_tpu_torch.parallel.multihost import (
        CoordinatedGuardian, MultiHostRunner, PeerCoordinator)
    c = PeerCoordinator(sync_every=1, peer_timeout=peer_timeout,
                        namespace=ns, dump_dir=str(MH_DIR))
    g = CoordinatedGuardian(c, warmup_steps=10 ** 6) if guardian else None
    kw.setdefault("save_every", MH["save_every"])
    return MultiHostRunner(trainer, str(MH_DIR / directory), c, guardian=g,
                           rng_seed=MH["seed"], monitor=False, sigterm=False,
                           **kw)


def _mh_drive(r, cfg, total, rows, g, on_step=None):
    """Run `r` to step `total` from wherever it stands; returns (params,
    opt_state, losses, ms per fit_batch)."""
    from deeplearning4j_tpu_torch.parallel.multihost import global_batch
    p, o = r._live
    losses, ms = [], []
    while r.step < total:
        b = global_batch(r.trainer.mesh, _mh_batch(cfg, r.step, rows, g),
                         accumulation=g)
        _par_sync()
        t0 = time.perf_counter()
        p, o, loss = r.fit_batch(p, o, b)
        _par_sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(None if loss is None else float(loss))
        if on_step is not None:
            on_step(r, p, o)
    r._live = (p, o)
    return p, o, losses, ms


def _mh_start(r, params):
    r._live = r.resume_or_init(params)
    return r


def _mh_time(tr, params, cfg, steps):
    """ms per optimizer step of a bare trainer (one warm-up step first)."""
    from deeplearning4j_tpu_torch.parallel.multihost import global_batch
    p, o = tr.init(params)
    b = global_batch(tr.mesh, _mh_batch(cfg, 0, MH["batch"], MH["accum"]),
                     accumulation=MH["accum"])
    tr.fit_batch(p, o, b)
    _par_sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        tr.fit_batch(p, o, b)
    _par_sync()
    return (time.perf_counter() - t0) * 1e3 / steps


def _mh_overlap_trace(tr, params, cfg):
    """One compressed step under torch.profiler: the start order of the
    bucket phases' record_function ranges (host side) and the NCCL kernels
    the trace shows on the card."""
    from deeplearning4j_tpu_torch.parallel.multihost import global_batch
    p, o = tr.init(params)
    b = global_batch(tr.mesh, _mh_batch(cfg, 0, MH["batch"], MH["accum"]),
                     accumulation=MH["accum"])
    tr.fit_batch(p, o, b)
    _par_sync()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if DEV == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        tr.fit_batch(p, o, b)
        _par_sync()
    evs = [e for e in prof.events()]
    # the host-side record_function ranges (the card's user annotations
    # repeat their names)
    ranges = sorted((e.time_range.start, e.name) for e in evs
                    if e.name.startswith("dl4j_bucket")
                    and "CPU" in str(getattr(e, "device_type", "CPU")))
    nccl = [e for e in evs if "nccl" in e.name.lower()
            and getattr(e, "device_type", None) is not None
            and "CUDA" in str(e.device_type)]
    return [n for _, n in ranges], len(nccl)


def _mh_arm_a(part, res):
    """Arm A, NCCL, one rank. "run": the runner's clean 4 steps (launch
    counts, the residual-mass check on step 1, encoder stats, the recorded
    exchange order, the coordinated save), raw buckets against
    ShardedTrainer bit for bit, the timings and the profiled step, then a
    run preempted at host.preempt. "resume": a fresh process resumes the
    preempted run's checkpoint to step 4."""
    from deeplearning4j_tpu_torch.parallel import ShardedTrainer
    from deeplearning4j_tpu_torch.parallel.buckets import \
        check_overlap_structure
    from deeplearning4j_tpu_torch.parallel.multihost import (
        MultiHostTrainer, global_batch)
    from deeplearning4j_tpu_torch.resilience.errors import PreemptionSignal
    cfg = _mh_cfg()
    params = init_bert_params(cfg, 0, device=DEV)
    loss_fn = _mh_loss(cfg)
    G, B, steps = MH["accum"], MH["batch"], MH["steps"]

    def trainer(compress=True):
        return MultiHostTrainer(loss_fn, Adam(MH["lr"]), compress=compress,
                                accumulation=G, buckets=MH["buckets"])

    if part == "resume":
        r = _mh_start(_mh_runner("a-pre", "a-res", trainer(),
                                 MH["peer_timeout"]), params)
        res["resumed_at"] = r.resumed_step
        p, o, losses, _ = _mh_drive(r, cfg, steps, B, G)
        res["digest"] = _mh_digest({"params": p, "opt_state": o})
        res["losses"] = losses
        r.close()
        return
    # the clean run, counts from 0 just before its steps
    r = _mh_start(_mh_runner("a-clean", "a-clean", trainer(),
                             MH["peer_timeout"]), params)
    r.trainer.keep_exchange = True
    old = [t.clone() for t in r._live[1]["encoder"]["residual"].values()]
    mass = []

    def check_mass(r, p, o):
        ex = r.trainer.last_exchange
        if ex is None:
            return
        for b, (e, r0) in enumerate(zip(ex, old)):
            r1 = o["encoder"]["residual"][str(b)][0]
            rhs = e["flat"] + r0[0]
            mass.append({"bucket": b, "elems": int(rhs.numel()),
                         "err": float(((e["sent"] + r1) - rhs).abs().max()),
                         "scale": float(rhs.abs().max()),
                         "delivered_is_sent": bool(torch.equal(
                             e["delivered"], e["sent"])),
                         "shipped": int((e["sent"] != 0).sum())})
        r.trainer.keep_exchange = False
        r.trainer.last_exchange = None
        old.clear()

    _par_sync()
    _reset_counts()
    p, o, losses, ms = _mh_drive(r, cfg, steps, B, G, on_step=check_mass)
    res["launches"] = _counts()
    nb = r.trainer.bucket_plan.num_buckets
    res["bucket_bytes"] = list(r.trainer.bucket_plan.bucket_bytes)
    res["mass"] = mass
    res["stats"] = r.trainer.encoder_stats(o)
    res["log"] = list(r.trainer.exchange_log)
    res["log_problems"] = check_overlap_structure(res["log"], nb,
                                                  require_async=True)
    res["losses"], res["runner_ms"] = losses, ms
    res["digest"] = _mh_digest({"params": p, "opt_state": o})
    res["guardian"] = {"skipped": r.guardian.skipped,
                       "flushes": r.guardian._flushes}
    r.close()
    del r, p, o, old
    gc.collect()
    _mh_empty()
    # raw buckets against ShardedTrainer: one step, bit for bit
    raw = trainer(compress=False)
    sh = ShardedTrainer(loss_fn, Adam(MH["lr"]), raw.mesh, accumulation=G)
    pr, sr = raw.init(params)
    ps, ss = sh.init(params)
    b = global_batch(raw.mesh, _mh_batch(cfg, 0, B, G), accumulation=G)
    gens = []
    for _ in range(2):
        gen = torch.Generator(device=DEV)
        gen.manual_seed(MH["seed"])
        gens.append(gen)
    _, _, la = raw.fit_batch(pr, sr, b, gens[0])
    _, _, lb = sh.fit_batch(ps, ss, b, gens[1])
    from deeplearning4j_tpu_torch.resilience.integrity import flatten
    res["raw_equal"] = {
        "leaves": len(flatten({"p": pr, "s": sr})),
        "loss_equal": bool(torch.equal(la, lb)),
        "unequal": _mh_unequal({"p": pr, "s": sr}, {"p": ps, "s": ss})}
    del pr, sr, ps, ss, sh
    gc.collect()
    _mh_empty()
    res["raw_ms"] = _mh_time(raw, params, cfg, MH["timed"])
    del raw
    gc.collect()
    _mh_empty()
    tr = trainer()
    res["compressed_ms"] = _mh_time(tr, params, cfg, MH["timed"])
    order, nccl = _mh_overlap_trace(tr, params, cfg)
    res["trace"] = {"order": order, "nccl_kernels": nccl,
                    "problems": check_overlap_structure(
                        order, tr.bucket_plan.num_buckets,
                        require_async=True)}
    del tr
    gc.collect()
    _mh_empty()
    # preempted at host.preempt: the coordinated drain
    plan = faults.FaultPlan(seed=0).fail_at(
        faults.HOST_PREEMPT, MH["preempt_at"],
        exc=lambda site, n: PreemptionSignal(f"injected at {site} call {n}"))
    r = _mh_start(_mh_runner("a-pre", "a-pre", trainer(),
                             MH["peer_timeout"]), params)
    drained = None
    with plan:
        try:
            _mh_drive(r, cfg, steps, B, G)
        except PreemptionSignal:
            drained = r.step
    res["drained"] = drained
    # the drain is the coordinated save with wait=True
    res["save"] = r.last_save
    r.close()


def _mh_arm_b(part, rank, world, res, out_file):
    """Arm B, two gloo ranks on one card. "b1": dense and sparse wire from
    one start (bit for bit), then a run preempted on rank 1. "b2": a fresh
    pair resumes the preempted run (bit for bit the dense run), a graceful
    leave 2 → 1 and a join_cluster 1 → 2, then rank 1 dies inside a sync
    round."""
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.parallel import multihost as mh
    from deeplearning4j_tpu_torch.parallel.mesh import DeviceMesh
    from deeplearning4j_tpu_torch.resilience.errors import (PeerLostError,
                                                            PreemptionSignal)
    cfg = _mh_cfg(MH["b_layers"])
    params = init_bert_params(cfg, 0, device=DEV)
    loss_fn = _mh_loss(cfg)
    B, steps = MH["b_batch"], MH["b_steps"]

    def trainer(wire="dense", mesh=None):
        return mh.MultiHostTrainer(loss_fn, Adam(MH["lr"]), mesh=mesh,
                                   buckets=MH["buckets"], wire=wire,
                                   wire_capacity=1.0)

    def write():
        out_file.write_text(json.dumps(res, default=str))

    if part == "b1":
        for wire in ("dense", "sparse"):
            r = _mh_start(_mh_runner(f"b-{wire}", f"b-{wire}", trainer(wire),
                                     MH["b_peer_timeout"] * 3,
                                     save_every=10 ** 6), params)
            _reset_counts()
            p, o, losses, ms = _mh_drive(r, cfg, steps, B, 1)
            res[wire] = {"digest": _mh_digest({"params": p, "opt_state": o}),
                         "losses": losses, "ms": ms, "launches": _counts(),
                         "stats": r.trainer.encoder_stats(o)}
            r.close()
        plan = faults.FaultPlan(seed=0)
        if rank == 1:
            plan.fail_at(faults.HOST_PREEMPT, MH["b_preempt_at"],
                         exc=lambda site, n: PreemptionSignal(
                             f"injected at {site} call {n}"))
        r = _mh_start(_mh_runner("b-pre", "b-pre", trainer(),
                                 MH["b_peer_timeout"] * 3), params)
        with plan:
            try:
                _mh_drive(r, cfg, steps, B, 1)
            except PreemptionSignal:
                res["drained"] = r.step
        r.close()
        return
    # -- b2: resume, leave and join, die --------------------------------------
    r = _mh_start(_mh_runner("b-pre", "b-res", trainer(),
                             MH["b_peer_timeout"] * 3), params)
    res["resumed_at"] = r.resumed_step
    p, o, _, _ = _mh_drive(r, cfg, steps, B, 1)
    res["resume_digest"] = _mh_digest({"params": p, "opt_state": o})
    r.close()
    del r, p, o
    write()
    el = {"widths": []}

    def coordinator():
        return mh.PeerCoordinator(sync_every=1,
                                  peer_timeout=MH["b_peer_timeout"] * 3,
                                  process_id=rank, num_processes=world,
                                  namespace="b-el", dump_dir=str(MH_DIR))

    c = coordinator()
    m = mh.ElasticMembership(c)
    factory = mh.GroupMeshFactory(c, backend="gloo",
                                  timeout_s=MH["pg_timeout_s"])
    r = _mh_start(mh.MultiHostRunner(
        trainer(mesh=DeviceMesh(dp=world)), str(MH_DIR / "b-el"), c,
        save_every=MH["b_save_every"], elastic=True, mesh_factory=factory,
        membership=m, rng_seed=MH["seed"], monitor=False, sigterm=False),
        params)
    total = MH["b_total"]

    def on_step(rr, p, o):
        el["widths"].append((rr.step, rr.trainer.dp))

    if rank == 1:
        try:
            while True:
                if r.step == MH["b_leave_at"]:
                    r.request_leave()
                _mh_drive(r, cfg, r.step + 1, B, 1, on_step)
        except PreemptionSignal:
            el["left_at"] = r.step
        r.close()
        c = coordinator()
        r, p, o = mh.MultiHostRunner.join_cluster(
            lambda mesh: trainer(mesh=mesh), str(MH_DIR / "b-el"), c,
            mh.GroupMeshFactory(c, backend="gloo",
                                timeout_s=MH["pg_timeout_s"]),
            params, timeout=120.0, save_every=MH["b_save_every"],
            rng_seed=MH["seed"], monitor=False, sigterm=False)
        r._live = (p, o)
        el["joined_at"] = r.step
        el["joined_zero"] = all(not bool(t.any()) for t in
                                o["encoder"]["residual"].values())
        el["joined_thr"] = o["encoder"]["threshold"].cpu().tolist()
    else:
        joined = False
        while r.step < total:
            before = r.trainer.dp
            p, o, _, _ = _mh_drive(r, cfg, r.step + 1, B, 1, on_step)
            if before == 2 and r.trainer.dp == 1:
                snap = r._last_host_state["opt_state"]["encoder"]
                el["left_at"] = r.step
                el["leave_mass_err"] = max(float(
                    (snap["residual"][k].sum(0).to(t.device) - t[0]).abs()
                    .max()) for k, t in o["encoder"]["residual"].items())
                deadline = time.monotonic() + 120
                while not m.pending()[0] and time.monotonic() < deadline:
                    time.sleep(0.05)
            if before == 1 and r.trainer.dp == 2 and not joined:
                joined = True
                el["joined_at"] = r.step
                el["joined_thr"] = o["encoder"]["threshold"].cpu().tolist()
    p, o, _, _ = _mh_drive(r, cfg, total, B, 1, on_step)
    el["members"] = list(r.coordinator.members)
    el["world"] = dist.get_world_size()
    el["params_digest"] = _mh_digest(p)
    r.close()
    res["elastic"] = el
    del r, p, o
    write()
    # die@R: rank 1 exits inside its sync round; rank 0 must raise
    # PeerLostError within the peer timeout plus slack
    r = _mh_start(_mh_runner("b-die", "b-die", trainer(),
                             MH["b_peer_timeout"], guardian=False), params)
    plan = faults.FaultPlan(seed=0)
    if rank == 1:
        write()
        plan.fail_at(faults.HOST_PREEMPT, MH["b_die_at"],
                     exc=lambda site, n: os._exit(23))
    die = {}
    b = None
    with plan:
        try:
            while r.step < steps:
                b = mh.global_batch(r.trainer.mesh,
                                    _mh_batch(cfg, r.step, B, 1))
                t0 = time.perf_counter()
                p, o, _ = r.fit_batch(*r._live, b)
                r._live = (p, o)
        except PeerLostError as e:
            die = {"step": r.step, "seconds": time.perf_counter() - t0,
                   "message": str(e)[:300],
                   "report": bool(e.report_path
                                  and os.path.exists(e.report_path)),
                   "peers": sorted(str(k) for k in (e.peers or {}))}
    res["die"] = die
    r.close()


def _mh_rank(rank, world, arm, part, port, knobs):
    """One rank of a multihost arm: the hardened bootstrap on a loopback
    TCPStore (process 0 hosts it), the arm's part, its results as JSON."""
    import traceback
    global DEV
    DEV = knobs["DEV"]
    MH.update(knobs["MH"])
    _child_timeline(f"multihost_{arm}_{part}{rank}", knobs.get("t0"), (
        "init_bert_params", "_mh_start", "_mh_drive", "_mh_time",
        "_mh_overlap_trace"))
    out_file = MH_DIR / f"{arm}.{part}.{rank}.json"
    res = {"rank": rank, "arm": arm, "part": part}
    try:
        from deeplearning4j_tpu_torch.parallel import multihost as mh
        if DEV == "cuda":
            torch.cuda.set_device(0)
        backend = MH["backend_a"] if arm == "A" else "gloo"
        mh.initialize(f"127.0.0.1:{port}", world, rank, backend=backend,
                      timeout_s=MH["pg_timeout_s"],
                      device="cuda:0" if backend == "nccl" else None)
        if arm == "A":
            _mh_arm_a(part, res)
        else:
            _mh_arm_b(part, rank, world, res, out_file)
        res["nvcc_runs"] = _build.nvcc_runs
    except Exception:
        res["error"] = traceback.format_exc()
    finally:
        out_file.write_text(json.dumps(res, default=str))
        from deeplearning4j_tpu_torch.parallel import multihost as mh
        mh._teardown()


#: the ports _mh_spawn has handed out (arms spawn side by side)
_MH_PORTS = set()
_MH_PORTS_LOCK = threading.Lock()


def _mh_spawn(arm, part, world, deadline_s, exits=None):
    """Start `world` rank processes, join each against the deadline; a rank
    that outlives it, or exits with another code than `exits` names for it
    (0 by default), fails the phase. Returns the ranks' results."""
    import multiprocessing as mp
    import socket
    with _MH_PORTS_LOCK:
        while True:
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            if port not in _MH_PORTS:
                _MH_PORTS.add(port)
                break
    for r in range(world):
        f = MH_DIR / f"{arm}.{part}.{r}.json"
        if f.exists():
            f.unlink()
    knobs = {"DEV": DEV, "MH": dict(MH),
             "t0": _TIMELINE[1] if _TIMELINE else None}
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_mh_rank,
                         args=(r, world, arm, part, port, knobs))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(max(1.0, deadline_s - (time.perf_counter() - t0)))
        if any(p.is_alive() for p in procs):
            raise AssertionError(f"multihost arm {arm} {part}: a rank passed "
                                 f"its {deadline_s} s deadline")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
    seconds = time.perf_counter() - t0
    results = []
    for r, p in enumerate(procs):
        want = (exits or {}).get(r, 0)
        res = json.loads((MH_DIR / f"{arm}.{part}.{r}.json").read_text())
        if "error" in res:
            raise AssertionError(f"multihost arm {arm} {part} rank {r}:\n"
                                 f"{res['error']}")
        if p.exitcode != want:
            raise AssertionError(f"multihost arm {arm} {part} rank {r} exited "
                                 f"{p.exitcode}, expected {want}")
        if res.get("nvcc_runs"):
            raise AssertionError(f"multihost arm {arm} {part} rank {r} "
                                 f"compiled {res['nvcc_runs']} kernels")
        results.append(res)
    return results, seconds


def _mh_gate(ok, what):
    if not ok:
        raise AssertionError(f"multihost: {what}")


def _mh_empty():
    if DEV == "cuda":
        torch.cuda.empty_cache()


def phase_multihost():
    """Arm A (NCCL, one rank: a run process and a fresh resume process) and
    arm B (two gloo ranks on the first card: two spawns of a pair)."""
    if MH_DIR.exists():
        shutil.rmtree(MH_DIR)
    MH_DIR.mkdir(parents=True)
    gc.collect()
    _mh_empty()
    # arm B's pairs in a thread beside arm A's processes: each arm's
    # processes wait on their own spawn, and the arms share no file, store
    # or port
    arm_b = {}

    def run_b():
        try:
            arm_b["b1"] = _mh_spawn("B", "b1", 2, MH["deadline_b_s"])
            arm_b["b2"] = _mh_spawn("B", "b2", 2, MH["deadline_b_s"],
                                    exits={1: 23})
        except BaseException as e:   # re-raised below, after arm A
            arm_b["error"] = e

    thread = threading.Thread(target=run_b, name="multihost-arm-b")
    thread.start()
    try:
        (a,), a_s = _mh_spawn("A", "run", 1, MH["deadline_a_s"])
        (ar,), ar_s = _mh_spawn("A", "resume", 1, MH["deadline_a_s"])
    finally:
        thread.join()
    if "error" in arm_b:
        raise arm_b["error"]
    (b1, b1_s), (b2, b2_s) = arm_b["b1"], arm_b["b2"]
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "smoke_multihost_ranks.json").write_text(json.dumps(
        {"arm_a": [a, ar], "arm_b1": b1, "arm_b2": b2}, indent=1,
        default=str))
    steps = MH["steps"]
    per_step = {k: a["launches"][k] / steps for k in PAR_BERT_KERNELS}
    want_launches = _mh_cfg().num_layers * MH["accum"]
    st = a["stats"]
    save_step, save_s, save_bytes = a["save"]
    log(f"[multihost] arm A: {MH['backend_a']}, one rank; BERT-base width x "
        f"{_mh_cfg().num_layers} layers "
        f"B={MH['batch']} "
        f"T={MH['seq']} x G={MH['accum']} dropout 0.1 Adam({MH['lr']}), "
        f"{MH['buckets']} buckets {a['bucket_bytes']} B, compressed: "
        f"{a['compressed_ms']:.2f} ms/optimizer step (trainer), raw buckets "
        f"{a['raw_ms']:.2f}; through the runner (coordinated saves every "
        f"{MH['save_every']}, guardian sync every step) "
        f"{[round(x, 2) for x in a['runner_ms']]} ms; launches per optimizer "
        f"step {per_step} (want {want_launches} each)")
    log(f"[multihost] arm A coordinated save (the drain, wait=True, step "
        f"{save_step}): "
        f"{save_s:.3f} s, {save_bytes} B; encoder_stats: threshold "
        f"{st['threshold']:.3e}, nnz {st['nnz']}, residual norm "
        f"{st['residual_norm']:.4e}, bucket nnz {st['bucket_nnz']}")
    log(f"[multihost] arm A raw buckets vs ShardedTrainer, one step: "
        f"{a['raw_equal']['leaves']} leaves, unequal "
        f"{a['raw_equal']['unequal']}, loss equal "
        f"{a['raw_equal']['loss_equal']}")
    log(f"[multihost] arm A residual mass per bucket (step 1): "
        + ", ".join(f"b{m['bucket']} err {m['err']:.3e} of "
                    f"{m['scale']:.3e} ({m['shipped']} shipped)"
                    for m in a["mass"]))
    log(f"[multihost] arm A overlap: recorded order {a['log']} -> problems "
        f"{a['log_problems']}; profiler trace order {a['trace']['order']} "
        f"-> problems {a['trace']['problems']}, NCCL kernels in the trace "
        f"{a['trace']['nccl_kernels']}")
    log(f"[multihost] arm A preempted at host.preempt call "
        f"{MH['preempt_at']}: drained at step {a['drained']}; a fresh "
        f"process resumed at "
        f"{ar['resumed_at']} and ran to step {steps}: "
        f"{sum(ar['digest'][k] == a['digest'][k] for k in a['digest'])}/"
        f"{len(a['digest'])} leaves bit-equal to the clean run")
    r0, r1 = b2
    el0, el1 = r0["elastic"], r1["elastic"]
    log(f"[multihost] arm B: 2 gloo ranks on one card (host-staged), "
        f"BERT-base width x {MH['b_layers']} layers, B={MH['b_batch']}: "
        f"dense ms/step {[round(x, 1) for x in b1[0]['dense']['ms']]}, "
        f"sparse {[round(x, 1) for x in b1[0]['sparse']['ms']]}; sparse "
        f"wire bytes {b1[0]['sparse']['stats'].get('wire_bytes')} vs dense "
        f"{b1[0]['sparse']['stats'].get('dense_bytes')}")
    log(f"[multihost] arm B preempt@{MH['b_preempt_at']} drained at "
        f"{[r['drained'] for r in b1]}, resumed at "
        f"{[r['resumed_at'] for r in b2]}; leave at {el0.get('left_at')} "
        f"(mass err {el0.get('leave_mass_err')}), join at "
        f"{el0.get('joined_at')}/{el1.get('joined_at')}, widths "
        f"{el0['widths']}; die@{MH['b_die_at']}: {r0['die']}")
    log(f"[multihost] A {a_s:.1f} s + resume {ar_s:.1f} s, beside B1 "
        f"{b1_s:.1f} s + B2 {b2_s:.1f} s (process start, imports and kernel "
        "loads included; the arms share the card and the host, so each "
        "arm's times include the other's load)")
    # -- gates ---------------------------------------------------------------
    _mh_gate(DEV != "cuda" or all(v == want_launches
                                  for v in per_step.values()),
             f"arm A launches per optimizer step {per_step}")
    _mh_gate(not a["raw_equal"]["unequal"] and a["raw_equal"]["loss_equal"],
             f"raw buckets vs ShardedTrainer: {a['raw_equal']}")
    _mh_gate(all(m["err"] <= MH_MASS_RTOL * max(m["scale"], 1e-30)
                 and m["delivered_is_sent"] for m in a["mass"])
             and len(a["mass"]) == MH["buckets"],
             f"residual mass {a['mass']}")
    _mh_gate(not a["log_problems"] and not a["trace"]["problems"],
             f"overlap {a['log_problems']} {a['trace']['problems']}")
    _mh_gate(a["drained"] == MH["preempt_at"] and ar["resumed_at"]
             == a["drained"], f"drain {a['drained']} resume "
             f"{ar['resumed_at']}")
    _mh_gate(ar["digest"] == a["digest"],
             "arm A resumed run differs from the clean run: "
             + str([k for k in a["digest"]
                    if ar["digest"].get(k) != a["digest"][k]][:8]))
    _mh_gate(a["guardian"]["skipped"] == 0, f"guardian {a['guardian']}")
    for r, rr in zip(b1, b2):
        _mh_gate(r["sparse"]["digest"] == r["dense"]["digest"]
                 and r["sparse"]["losses"] == r["dense"]["losses"],
                 f"rank {r['rank']}: sparse wire differs from dense")
        _mh_gate(r["drained"] == MH["b_preempt_at"]
                 and rr["resumed_at"] == r["drained"],
                 f"rank {r['rank']}: drain {r.get('drained')} resume "
                 f"{rr.get('resumed_at')}")
        _mh_gate(rr["resume_digest"] == r["dense"]["digest"],
                 f"rank {r['rank']}: resumed pair differs from the clean run")
        _mh_gate(DEV != "cuda" or all(
            r["dense"]["launches"][k] == MH["b_layers"] * MH["b_steps"]
            for k in PAR_BERT_KERNELS),
            f"arm B launches {r['dense']['launches']}")
    _mh_gate(el0["leave_mass_err"] == 0.0, f"leave mass {el0}")
    _mh_gate(el1["joined_zero"] and el1["joined_thr"] == el0["joined_thr"],
             f"join re-stack {el0.get('joined_thr')} {el1.get('joined_thr')}")
    _mh_gate(el0["joined_at"] == el1["joined_at"]
             and el0["members"] == el1["members"] == [0, 1]
             and el0["world"] == el1["world"] == 2
             and el0["params_digest"] == el1["params_digest"],
             "lockstep after the join")
    die = r0["die"]
    _mh_gate(die.get("report") and die.get("step") is not None,
             f"die: {die}")
    _mh_gate(die["seconds"] <= MH["b_peer_timeout"] + MH_LOST_SLACK_S,
             f"die: PeerLostError after {die['seconds']} s")
    launches = {k.__name__: 0 for k in KERNELS}
    for k, v in a["launches"].items():
        launches[k] += v
    return {"arm_a": a, "arm_a_resume": ar, "arm_b1": b1, "arm_b2": b2,
            "seconds": {"A": a_s, "A_resume": ar_s, "B1": b1_s, "B2": b2_s},
            "launches": launches, "launches_per_step": per_step}


def kernel_line(rows, launches, launches_from):
    """The per-kernel JSON object: each kernel's numbers at its
    representative case, its launches (from the main path's run where it
    has one; `launches_from` names the run), and its error in the checked
    case of the same dtype that came nearest its atol."""
    out = []
    for name, (case, dt) in REPRESENTATIVE.items():
        r = next(x for x in rows
                 if x["name"] == name and x["case"] == case
                 and x["dtype"] == dt)
        worst = max((x for x in rows if x["name"] == name
                     and x["dtype"] == dt),
                    key=lambda x: x["max_abs_err"] / x["atol"])
        src, replaces = SOURCES[name]
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": worst["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"], "case": case,
                    "shape": r["shape"], "dtype": dt,
                    "atol": worst["atol"], "err_case": worst["case"],
                    "launches_from": launches_from[name]})
    return {"kernels": out}


# -- phase 22: keras --------------------------------------------------------------
#: Keras MobileNetV2 (Sandler et al., 2018; keras.applications.MobileNetV2:
#: alpha 1.0, 224×224×3, 1000 classes), imported with the conv1x1+BN
#: fusion on: one B=32 forward through the bucket graph, then profiled,
#: warm-up and timed graphed fit steps at B=32
KERAS = dict(alpha=1.0, size=224, classes=1000, batch=32, warmup=2, timed=10,
             steps=3, seed=23, pairs=34, bert_steps=3)
#: fused vs unfused MobileNetV2 forward on the card: max |fused - unfused|
#: <= KERAS_RTOL * max |unfused| (f32 sums in another order)
KERAS_RTOL = 1e-4
#: Keras's parameter count of the model (trainable 3,504,872 and the BN
#: moving statistics 34,112)
MOBILENET_V2_PARAMS = 3_538_984
#: MobileNetV2's inverted residual blocks: (expansion, filters, stride)
MOBILENET_V2_BLOCKS = ((1, 16, 1), (6, 24, 2), (6, 24, 1), (6, 32, 2),
                       (6, 32, 1), (6, 32, 1), (6, 64, 2), (6, 64, 1),
                       (6, 64, 1), (6, 64, 1), (6, 96, 1), (6, 96, 1),
                       (6, 96, 1), (6, 160, 2), (6, 160, 1), (6, 160, 1),
                       (6, 320, 1))
#: the profiled kernels of a fused training step and their wrappers
PROFILED_TRAIN = (("matmul_stats_kernel", "matmul_stats"),
                  ("bn_grad_stats_kernel", "bn_grad_stats"),
                  ("bn_conv_grads_kernel", "bn_conv_grads"))
PROFILED_BERT = (("flash_fwd_kernel", "flash_fwd"),
                 ("flash_bwd_dq_kernel", "flash_bwd_dq"),
                 ("flash_bwd_dkv_kernel", "flash_bwd_dkv"))
KERAS_DIR = Path(__file__).resolve().parent / "build" / "keras"


def _make_divisible(v, divisor=8):
    """keras.applications.mobilenet_v2's channel rounding."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def keras_mobilenet_v2(alpha=1.0, size=224, classes=1000, blocks=None):
    """The Functional JSON (a dict) that Keras writes for
    `keras.applications.MobileNetV2(alpha, input_shape=(size, size, 3),
    classes=classes, weights=None)`: its layer names and settings —
    `ReLU(6.)`, `DepthwiseConv2D`, `ZeroPadding2D` with `correct_pad`,
    `BatchNormalization(epsilon=1e-3, momentum=0.999)`, 1×1
    `Conv2D(use_bias=False)`. `blocks` keeps the first inverted residual
    blocks only (a narrow test model)."""
    init = {"class_name": "GlorotUniform", "config": {"seed": None}}
    layers = []

    def add(cls, name, cfg, inbound):
        layers.append({"class_name": cls, "name": name,
                       "config": dict(cfg, name=name, trainable=True),
                       "inbound_nodes": ([[[i, 0, 0, {}] for i in inbound]]
                                         if inbound else [])})
        return name

    def conv(name, x, filters, k, stride=1):
        return add("Conv2D", name, {
            "filters": filters, "kernel_size": [k, k],
            "strides": [stride, stride], "padding": "same",
            "data_format": "channels_last", "dilation_rate": [1, 1],
            "groups": 1, "activation": "linear", "use_bias": False,
            "kernel_initializer": init}, [x])

    def bn(name, x):
        return add("BatchNormalization", name, {
            "axis": -1, "momentum": 0.999, "epsilon": 1e-3, "center": True,
            "scale": True}, [x])

    def relu6(name, x):
        return add("ReLU", name, {"max_value": 6.0, "negative_slope": 0.0,
                                  "threshold": 0.0}, [x])

    x = add("InputLayer", "input_1", {
        "batch_input_shape": [None, size, size, 3], "dtype": "float32",
        "sparse": False, "ragged": False}, [])
    hw, ch = -(-size // 2), _make_divisible(32 * alpha, 8)
    x = relu6("Conv1_relu", bn("bn_Conv1", conv("Conv1", x, ch, 3, 2)))
    for i, (t, c, s) in enumerate(MOBILENET_V2_BLOCKS[:blocks]):
        inp, out_ch = x, _make_divisible(int(c * alpha), 8)
        prefix = f"block_{i}_" if i else "expanded_conv_"
        if i:
            x = relu6(prefix + "expand_relu", bn(
                prefix + "expand_BN", conv(prefix + "expand", x, t * ch, 1)))
        if s == 2:
            adj = 1 - hw % 2        # imagenet_utils.correct_pad
            x = add("ZeroPadding2D", prefix + "pad", {
                "padding": [[1 - adj, 1], [1 - adj, 1]],
                "data_format": "channels_last"}, [x])
            hw = (hw + 2 - adj - 3) // 2 + 1
        x = add("DepthwiseConv2D", prefix + "depthwise", {
            "kernel_size": [3, 3], "strides": [s, s],
            "padding": "same" if s == 1 else "valid", "depth_multiplier": 1,
            "data_format": "channels_last", "dilation_rate": [1, 1],
            "activation": "linear", "use_bias": False,
            "depthwise_initializer": init}, [x])
        x = relu6(prefix + "depthwise_relu", bn(prefix + "depthwise_BN", x))
        x = bn(prefix + "project_BN", conv(prefix + "project", x, out_ch, 1))
        if ch == out_ch and s == 1:
            x = add("Add", prefix + "add", {}, [inp, x])
        ch = out_ch
    last = _make_divisible(1280 * alpha, 8) if alpha > 1.0 else 1280
    x = relu6("out_relu", bn("Conv_1_bn", conv("Conv_1", x, last, 1)))
    x = add("GlobalAveragePooling2D", "global_average_pooling2d", {
        "data_format": "channels_last", "keepdims": False}, [x])
    add("Dense", "predictions", {
        "units": classes, "activation": "softmax", "use_bias": True,
        "kernel_initializer": init,
        "bias_initializer": {"class_name": "Zeros", "config": {}}}, [x])
    return {"class_name": "Functional", "keras_version": "2.13.1",
            "backend": "tensorflow",
            "config": {"name": f"mobilenetv2_{alpha:.2f}_{size}",
                       "layers": layers,
                       "input_layers": [["input_1", 0, 0]],
                       "output_layers": [["predictions", 0, 0]]}}


def mobilenet_v2_pairs(blocks=None):
    """The conv1x1+BN pairs the fusion finds: every expand conv (not block
    0's), every project conv and Conv_1."""
    n = len(MOBILENET_V2_BLOCKS[:blocks])
    return (n - 1) + n + 1


def _keras_batch(b, size, classes, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, size, size, 3)).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, b)]
    return DataSet(x, y)


def _report_kernels(report):
    """{kernel base name: (count, {categories})} over a profile report's
    rows of the port's own kernels."""
    out = {}
    for r in report["ops"]:
        base = xplane.kernel_base_name(r["name"])
        if base in xplane.port_kernel_names():
            n, cats = out.get(base, (0, set()))
            out[base] = (n + r["count"], cats | {r["category"]})
    return out


def _profile_check(what, session, steps, launches, pairs):
    """The session ended done over `steps` steps; each (kernel, wrapper)
    of `pairs` has a custom-call row whose count equals the wrapper's
    launch counter; the device self time fits in the wall time."""
    if session.state != "done":
        raise AssertionError(f"{what}: the profile session ended "
                             f"{session.state}: {session.error}")
    rep = session.report
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / f"profile_{re.sub(r'[^a-z0-9]+', '_', what.lower())}.json") \
        .write_text(json.dumps(rep, indent=1, default=str))
    if session.captured_steps != steps or rep["steps"] != steps:
        raise AssertionError(f"{what}: {session.captured_steps} steps "
                             f"captured, expected {steps}")
    rows = _report_kernels(rep)
    bad = []
    for kernel, wrapper in pairs:
        n, cats = rows.get(kernel, (0, set()))
        if n != launches[wrapper] or cats != {"custom-call"}:
            bad.append(f"{kernel}: {n} rows {sorted(cats)}, "
                       f"{launches[wrapper]} launches")
    for kernel, (n, cats) in rows.items():
        if cats != {"custom-call"}:
            bad.append(f"{kernel}: categories {sorted(cats)}")
    if "bn_conv_grads_sum_kernel" in rows:
        # bn_conv_grads' split-K partial sums: one launch per call
        n = rows["bn_conv_grads_sum_kernel"][0]
        if n != launches["bn_conv_grads"]:
            bad.append(f"bn_conv_grads_sum_kernel: {n} rows, "
                       f"{launches['bn_conv_grads']} bn_conv_grads calls")
    if not rep["device_self_ms"] <= rep["wall_ms"]:
        bad.append(f"device self {rep['device_self_ms']:.3f} ms > wall "
                   f"{rep['wall_ms']:.3f} ms")
    if bad:
        raise AssertionError(f"{what}: the profile disagrees: {bad}")
    log(f"[keras] {what} profile: {steps} steps, wall "
        f"{rep['wall_ms']:.3f} ms ({rep['wall_ms'] / steps:.3f} ms/step), "
        f"device self {rep['device_self_ms']:.3f} ms, {rep['op_count']} "
        f"ops; port kernels " + ", ".join(
            f"{k} x{n}" for k, (n, _) in sorted(rows.items())))
    for r in rep["ops"][:5]:
        log(f"[keras]   {r['self_ms']:10.3f} ms x{r['count']:<6} "
            f"{r['category']:<12} {r['name'][:90]}")
    for c in rep["categories"]:
        log(f"[keras]   category {c['category']:<12} {c['self_ms']:10.3f} "
            f"ms x{c['count']:<6} {c['pct']:5.1f}%")
    return {"steps": steps, "wall_ms": rep["wall_ms"],
            "device_self_ms": rep["device_self_ms"],
            "op_count": rep["op_count"],
            "kernels": {k: n for k, (n, _) in rows.items()},
            "top": [{"name": r["name"][:120], "self_ms": r["self_ms"],
                     "count": r["count"], "category": r["category"]}
                    for r in rep["ops"][:5]],
            "categories": rep["categories"]}


def _keras_nets():
    """(fused, unfused) MobileNetV2 imported from the Keras JSON on the
    card, the fused one's BN draws copied into the unfused one."""
    js = json.dumps(keras_mobilenet_v2(KERAS["alpha"], KERAS["size"],
                                       KERAS["classes"]))
    with _fusion(True):
        net = KerasModelImport.importKerasModelAndWeights(js, None)
    _perturb_bn(net, KERAS["seed"])
    with _fusion(False):
        plain = KerasModelImport.importKerasModelAndWeights(js, None)
    with torch.no_grad():
        for tree_a, tree_b in ((net._params, plain._params),
                               (net._state, plain._state)):
            for n, d in tree_a.items():
                for k, t in d.items():
                    tree_b[n][k].copy_(t)
    n_params = sum(t.numel() for tree in (net._params, net._state)
                   for d in tree.values() for t in d.values())
    pairs = len(net._fused_pairs)
    log(f"[keras] MobileNetV2 alpha {KERAS['alpha']} {KERAS['size']}x"
        f"{KERAS['size']}x3 {KERAS['classes']} classes imported from "
        f"Keras JSON ({len(json.loads(js)['config']['layers'])} layers): "
        f"{n_params:,} parameters and BN statistics; "
        f"find_conv1x1_bn_fusions: {pairs} pairs")
    if pairs != KERAS["pairs"] or plain._fused_pairs:
        raise AssertionError(f"keras: {pairs} fused pairs (expected "
                             f"{KERAS['pairs']}), "
                             f"{len(plain._fused_pairs)} unfused")
    if n_params != MOBILENET_V2_PARAMS:
        raise AssertionError(f"keras: {n_params} parameters, Keras counts "
                             f"{MOBILENET_V2_PARAMS}")
    return net, plain, n_params


def _keras_serve(net, plain, x):
    """One B=32 forward through the fused net's bucket graph against the
    unfused net's eager forward; B6 launches once per pair."""
    pi = (ParallelInference.Builder(net)
          .inferenceMode(InferenceMode.BATCHED).batchLimit(KERAS["batch"])
          .bucketLadder([KERAS["batch"]]).build())
    try:
        pi.warmup()
        _reset_counts()
        got = pi.output(x)
        launches = _counts()["matmul_epilogue"]
        st = pi.status()
    finally:
        pi.shutdown()
    want = plain.output(torch.as_tensor(x, device=DEV)).cpu().numpy()
    err = float(np.abs(got - want).max() / np.abs(want).max())
    fused_ms = time_ms(lambda: net.output(torch.as_tensor(x, device=DEV)),
                       iters=5)
    plain_ms = time_ms(lambda: plain.output(torch.as_tensor(x, device=DEV)),
                       iters=5)
    log(f"[keras] one B={KERAS['batch']} forward through the bucket graph: "
        f"{launches} matmul_epilogue launches ({KERAS['pairs']} pairs); "
        f"max|fused - unfused| / max|unfused| = {err:.3e} (rtol "
        f"{KERAS_RTOL:.0e}); eager output() fused {fused_ms:.3f} ms, "
        f"unfused {plain_ms:.3f} ms; top-1 equal on "
        f"{int((got.argmax(1) == want.argmax(1)).sum())}/{len(x)}")
    if launches != KERAS["pairs"]:
        raise AssertionError(f"keras: the fused forward launched "
                             f"matmul_epilogue {launches} times, expected "
                             f"{KERAS['pairs']}")
    if not err <= KERAS_RTOL:
        raise AssertionError(f"keras: fused forward differs from unfused "
                             f"by {err:.3e}")
    if st["aot_fallbacks"] or st["model_calls"] != 1:
        raise AssertionError(f"keras: the bucket graph did not serve: {st}")
    return {"launches": launches, "rel_err": err, "fused_ms": fused_ms,
            "unfused_ms": plain_ms}


def _keras_steps(net, ds, steps):
    """`steps` graphed fit steps: (ms per step, losses, launches)."""
    _reset_counts()
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        net.fit(ds)
        losses.append(net._score.detach().clone())
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    launches = _counts()
    losses = [float(v) for v in losses]
    if not np.isfinite(losses).all():
        raise AssertionError(f"keras: a loss is not finite: {losses}")
    want = {w: steps * KERAS["pairs"] for _, w in PROFILED_TRAIN}
    got = {w: launches[w] for _, w in PROFILED_TRAIN}
    if got != want:
        raise AssertionError(f"keras: training launches {got}, expected "
                             f"{want}")
    return ms, losses, launches


def _keras_train(net, ds):
    """A ProfileSession armed before the fresh import's first fit: that
    step captures the step's graph with the window still shut, and the
    window covers the next KERAS["steps"] replays. Then warm-up and
    KERAS["timed"] timed graphed fit steps, and ProfilerListener over one
    more step."""
    session = mon.profile_next_steps(KERAS["steps"], top=1_000_000)
    net.fit(ds)
    first = net.fit_status()
    if session.state != "armed" or first["captures"] != 1:
        raise AssertionError(f"keras: the first fit (the capture) left the "
                             f"session {session.state}: {first}")
    prof_ms, prof_losses, launches = _keras_steps(net, ds, KERAS["steps"])
    prof = _profile_check("MobileNetV2 training", session, KERAS["steps"],
                          launches, PROFILED_TRAIN)
    for _ in range(KERAS["warmup"]):
        net.fit(ds)
    ms, losses, _ = _keras_steps(net, ds, KERAS["timed"])
    st = net.fit_status()
    log(f"[keras] graphed fit at B={KERAS['batch']}: {ms:.3f} ms/step over "
        f"{KERAS['timed']} steps ({KERAS['batch'] * 1e3 / ms:.1f} images/s),"
        f" {prof_ms:.3f} ms/step over {KERAS['steps']} under the profile "
        f"armed before the first fit (its start, stop, export and decode "
        f"included); losses {[round(v, 4) for v in prof_losses + losses]}; "
        f"launches under the profile {launches}; captures "
        f"{st['captures']}, replays {st['replays']}, eager calls "
        f"{st['eager_calls']}")
    if st["captures"] != 1 or st["eager_calls"] or st["degradations"]:
        raise AssertionError(f"keras: the fit store did not replay one "
                             f"graph: {st}")
    KERAS_DIR.mkdir(parents=True, exist_ok=True)
    listener = ProfilerListener(trace_dir=str(KERAS_DIR / "listener"),
                                start_iter=net.getIterationCount() + 1,
                                trace_iters=1)
    net.setListeners(listener)
    try:
        net.fit(ds)
        net.fit(ds)
    finally:
        net.setListeners()
        shutil.rmtree(KERAS_DIR / "listener", ignore_errors=True)
    rep = listener.report
    if rep is None or rep["steps"] != 1 or not rep["op_count"]:
        raise AssertionError(f"keras: ProfilerListener gave no report: "
                             f"{rep}")
    log(f"[keras] ProfilerListener over one more step: "
        f"{rep['op_count']} ops, device self {rep['device_self_ms']:.3f} "
        f"ms, wall {rep['wall_ms']:.3f} ms")
    return {"ms_per_step": ms, "images_per_s": KERAS["batch"] * 1e3 / ms,
            "profiled_ms_per_step": prof_ms,
            "losses": prof_losses + losses, "launches": launches,
            "profile": prof,
            "listener": {"op_count": rep["op_count"],
                         "device_self_ms": rep["device_self_ms"],
                         "wall_ms": rep["wall_ms"]}}


def _keras_bert_profile(cfg, params):
    """Three BERT-base fine-tune steps of the train phase's model under a
    ProfileSession, driven through its step hooks."""
    batch = _train_batch(cfg)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    step = _trainer(cfg, params, batch, gen)
    step()
    step()
    torch.cuda.synchronize()
    n = KERAS["bert_steps"]
    session = mon.profile_next_steps(n, top=1_000_000)
    _reset_counts()
    for _ in range(n):
        session.step_start()
        step()
        session.step_end()
    launches = _counts()
    want = {w: n * cfg.num_layers for _, w in PROFILED_BERT}
    got = {w: launches[w] for _, w in PROFILED_BERT}
    if got != want:
        raise AssertionError(f"keras: BERT launches {got}, expected {want}")
    return _profile_check("BERT-base fine-tune", session, n, launches,
                          PROFILED_BERT)


def phase_keras(cfg, params):
    """Keras MobileNetV2 imported, served and trained on the card under the
    profiler, and BERT-base's fine-tune steps profiled."""
    net, plain, n_params = _keras_nets()
    ds = _keras_batch(KERAS["batch"], KERAS["size"], KERAS["classes"],
                      KERAS["seed"])
    serve = _keras_serve(net, plain, ds.features)
    del plain
    train = _keras_train(net, ds)
    bert = _keras_bert_profile(cfg, params)
    del net
    gc.collect()
    torch.cuda.empty_cache()
    return {"params": n_params, "pairs": KERAS["pairs"], "serve": serve,
            "train": train, "bert_profile": bert,
            "launches": train["launches"],
            "launches_bert": {w: bert["kernels"].get(k, 0)
                              for k, w in PROFILED_BERT}}


# -- phase 23: samediff -----------------------------------------------------------
#: a frozen BERT-base GraphDef (the port's bert_base() weights, seeded)
#: imported into SameDiff: B=8, T=128, ragged input masks; 3 fit steps of
#: a classification head
SAMEDIFF = dict(batch=8, seq=128, steps=3, lr=1e-5, seed=29)
#: imported graph vs the port's encoder (flash attention, B1): max |diff|
#: <= SAMEDIFF_RTOL * max |encoder| over the last hidden states of the
#: valid (unpadded) tokens
SAMEDIFF_RTOL = 1e-4
SAMEDIFF_DIR = Path(__file__).resolve().parent / "build" / "samediff"
SEQUENCE_OUTPUT = "bert/encoder/sequence_output"


def frozen_bert_graphdef(cfg, params, batch, seq, gelu="tanh"):
    """A frozen TensorFlow BERT GraphDef (bytes, written with the port's
    tfproto encoder) of `params` (the port's parameter tree): BERT's own
    ops — GatherV2 embeddings, layer norm as Mean / SquaredDifference /
    Rsqrt, MatMul / BatchMatMulV2 / Softmax attention under the additive
    mask (1 - mask) * -10000, GELU as google-research BERT's modeling.py
    writes it (`gelu="tanh"`: 0.5x(1 + tanh(√(2/π)(x + 0.044715x³)))) or
    as the erf form (`gelu="erf"`) — then the pooler and classifier
    ("logits"). Placeholders: input_ids, token_type_ids (int32, (B, T)),
    input_mask (f32, (B, T)); the last hidden states are
    "bert/encoder/sequence_output"."""
    from deeplearning4j_tpu_torch.autodiff import tfproto
    from deeplearning4j_tpu_torch.models.convert import params_to_numpy
    P = params_to_numpy(params)
    H, nh, hd = cfg.hidden_size, cfg.num_heads, cfg.head_dim
    B, T = batch, seq
    nodes = []

    def op(name, kind, ins, **attrs):
        nodes.append((name, kind, list(ins), attrs))
        return name

    def const(name, value):
        v = np.asarray(value)
        if v.dtype == np.float64:
            v = v.astype(np.float32)
        return op(name, "Const", [], value=v)

    def ints(name, values):
        return const(name, np.asarray(values, np.int32))

    def dense(name, x, w, b):
        return op(name + "/BiasAdd", "BiasAdd", [
            op(name + "/MatMul", "MatMul", [x, const(name + "/kernel", w)]),
            const(name + "/bias", b)])

    axes = ints("bert/last_axis", [-1])
    eps = const("bert/ln_eps", np.float32(cfg.layer_norm_eps))

    def layer_norm(name, x, gamma, beta):
        mu = op(name + "/moments/mean", "Mean", [x, axes], keep_dims=True)
        d = op(name + "/moments/SquaredDifference", "SquaredDifference",
               [x, mu])
        var = op(name + "/moments/variance", "Mean", [d, axes],
                 keep_dims=True)
        rstd = op(name + "/batchnorm/Rsqrt", "Rsqrt", [
            op(name + "/batchnorm/add", "AddV2", [var, eps])])
        nrm = op(name + "/batchnorm/mul", "Mul", [
            op(name + "/batchnorm/sub", "Sub", [x, mu]), rstd])
        scl = op(name + "/batchnorm/mul_1", "Mul",
                 [nrm, const(name + "/gamma", gamma)])
        return op(name + "/batchnorm/add_1", "AddV2",
                  [scl, const(name + "/beta", beta)])

    def gelu_of(name, x):
        half = const(name + "/half", np.float32(0.5))
        one = const(name + "/one", np.float32(1.0))
        if gelu == "erf":
            e = op(name + "/Erf", "Erf", [op(name + "/truediv", "Mul", [
                x, const(name + "/rsqrt2", np.float32(1 / np.sqrt(2)))])])
            cdf = op(name + "/mul", "Mul", [half, op(
                name + "/add", "AddV2", [one, e])])
        else:
            cube = op(name + "/Pow", "Pow",
                      [x, const(name + "/three", np.float32(3.0))])
            inner = op(name + "/add", "AddV2", [x, op(
                name + "/mul", "Mul",
                [const(name + "/c", np.float32(0.044715)), cube])])
            t = op(name + "/Tanh", "Tanh", [op(name + "/mul_1", "Mul", [
                const(name + "/sqrt_2_pi", np.float32(np.sqrt(2 / np.pi))),
                inner])])
            cdf = op(name + "/mul_2", "Mul", [half, op(
                name + "/add_1", "AddV2", [one, t])])
        return op(name + "/mul_3", "Mul", [x, cdf])

    ids = op("input_ids", "Placeholder", [])
    tts = op("token_type_ids", "Placeholder", [])
    mask = op("input_mask", "Placeholder", [])
    zero = ints("bert/axis0", 0)
    emb = P["embeddings"]
    x = op("bert/embeddings/GatherV2", "GatherV2", [
        const("bert/embeddings/word_embeddings", emb["word"]), ids, zero])
    tok = op("bert/embeddings/GatherV2_1", "GatherV2", [
        const("bert/embeddings/token_type_embeddings", emb["token_type"]),
        tts, zero])
    pos = op("bert/embeddings/position_slice", "StridedSlice", [
        const("bert/embeddings/position_embeddings", emb["position"]),
        ints("bert/embeddings/begin", [0, 0]),
        ints("bert/embeddings/end", [T, 0]),
        ints("bert/embeddings/strides", [1, 1])], end_mask=2)
    x = op("bert/embeddings/add_1", "AddV2", [
        op("bert/embeddings/add", "AddV2", [x, tok]), pos])
    x = layer_norm("bert/embeddings/LayerNorm", x, emb["ln_scale"],
                   emb["ln_bias"])
    x = op("bert/encoder/Reshape", "Reshape",
           [x, ints("bert/encoder/shape_2d", [B * T, H])])
    m4 = op("bert/encoder/mask4d", "Reshape",
            [mask, ints("bert/encoder/shape_mask", [B, 1, 1, T])])
    adder = op("bert/encoder/mul", "Mul", [
        op("bert/encoder/sub", "Sub",
           [const("bert/encoder/one", np.float32(1.0)), m4]),
        const("bert/encoder/neg", np.float32(-10000.0))])
    heads = ints("bert/encoder/shape_heads", [B, T, nh, hd])
    perm = ints("bert/encoder/perm", [0, 2, 1, 3])
    scale = const("bert/encoder/scale", np.float32(1.0 / np.sqrt(hd)))
    for li, L in enumerate(P["layers"]):
        pre = f"bert/encoder/layer_{li}/"

        def split_heads(name, t):
            return op(pre + name + "/transpose", "Transpose", [
                op(pre + name + "/reshape", "Reshape", [t, heads]), perm])

        qkv = {}
        for j, nm in enumerate(("query", "key", "value")):
            qkv[nm] = split_heads(f"attention/self/{nm}", dense(
                pre + f"attention/self/{nm}", x,
                L["qkv_W"][:, j * H:(j + 1) * H],
                L["qkv_b"][j * H:(j + 1) * H]))
        s = op(pre + "attention/self/MatMul", "BatchMatMulV2",
               [qkv["query"], qkv["key"]], adj_y=True)
        s = op(pre + "attention/self/add", "AddV2", [
            op(pre + "attention/self/Mul", "Mul", [s, scale]), adder])
        p = op(pre + "attention/self/Softmax", "Softmax", [s])
        c = op(pre + "attention/self/MatMul_1", "BatchMatMulV2",
               [p, qkv["value"]])
        c = op(pre + "attention/self/Reshape_3", "Reshape", [
            op(pre + "attention/self/transpose_3", "Transpose", [c, perm]),
            ints(pre + "attention/self/shape_2d", [B * T, H])])
        a = dense(pre + "attention/output/dense", c, L["proj_W"],
                  L["proj_b"])
        x = layer_norm(pre + "attention/output/LayerNorm",
                       op(pre + "attention/output/add", "AddV2", [a, x]),
                       L["ln1_scale"], L["ln1_bias"])
        h = gelu_of(pre + "intermediate/gelu", dense(
            pre + "intermediate/dense", x, L["ffn"]["up_W"],
            L["ffn"]["up_b"]))
        f = dense(pre + "output/dense", h, L["ffn"]["down_W"],
                  L["ffn"]["down_b"])
        x = layer_norm(pre + "output/LayerNorm",
                       op(pre + "output/add", "AddV2", [f, x]),
                       L["ln2_scale"], L["ln2_bias"])
    seq_out = op(SEQUENCE_OUTPUT, "Reshape",
                 [x, ints("bert/encoder/shape_3d", [B, T, H])])
    cls = op("bert/pooler/strided_slice", "StridedSlice", [
        seq_out, ints("bert/pooler/begin", [0, 0, 0]),
        ints("bert/pooler/end", [0, 1, 0]),
        ints("bert/pooler/strides", [1, 1, 1])],
        begin_mask=5, end_mask=5, shrink_axis_mask=2)
    pooled = op("bert/pooler/dense/Tanh", "Tanh", [dense(
        "bert/pooler/dense", cls, P["pooler"]["W"], P["pooler"]["b"])])
    dense("output", pooled, P["classifier"]["W"], P["classifier"]["b"])
    nodes.append(("logits", "Identity", ["output/BiasAdd"], {}))
    return tfproto.encode_graphdef(nodes)


def _samediff_inputs(cfg):
    rng = np.random.default_rng(SAMEDIFF["seed"])
    b, t = SAMEDIFF["batch"], SAMEDIFF["seq"]
    lens = rng.integers(t // 2, t + 1, b)
    lens[0] = t
    mask = (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)
    return {"input_ids": rng.integers(0, cfg.vocab_size, (b, t))
            .astype(np.int32),
            "token_type_ids": np.zeros((b, t), np.int32),
            "input_mask": mask,
            "labels": np.eye(cfg.num_labels, dtype=np.float32)[
                rng.integers(0, cfg.num_labels, b)]}


def phase_samediff(cfg, params):
    """A frozen BERT-base GraphDef through importFrozenTF on the card,
    against the port's encoder; 3 fit steps of a classification head; the
    archive saved and reloaded (load_samediff and ModelGuesser) with
    bit-identical outputs. None of the nine kernels launches."""
    inputs = _samediff_inputs(cfg)
    feeds = {k: inputs[k] for k in ("input_ids", "token_type_ids",
                                    "input_mask")}
    _reset_counts()
    t0 = time.perf_counter()
    data = frozen_bert_graphdef(cfg, params, SAMEDIFF["batch"],
                                SAMEDIFF["seq"])
    sd = importFrozenTF(data)
    import_s = time.perf_counter() - t0
    n_nodes = len(sd._nodes)
    got = sd.output(feeds, [SEQUENCE_OUTPUT])[SEQUENCE_OUTPUT].tensor
    ms = time_ms(lambda: sd.output(feeds, [SEQUENCE_OUTPUT]), iters=5)
    sd_launches = _counts()
    dev = torch.device(DEV)
    with torch.no_grad():
        want = bert_encode(cfg, params, torch.as_tensor(
            inputs["input_ids"], device=dev).long(), torch.as_tensor(
            inputs["token_type_ids"], device=dev).long(),
            attn_mask=torch.as_tensor(inputs["input_mask"], device=dev))
    enc_launches = _counts()["flash_fwd"] - sd_launches["flash_fwd"]
    # the valid tokens: the flash encoder zeroes a padded query row's
    # attention, a TF BERT graph attends from it (the rows no head reads)
    valid = torch.as_tensor(inputs["input_mask"], device=dev) > 0
    err = float((got - want)[valid].abs().max() / want[valid].abs().max())
    log(f"[samediff] frozen BERT-base GraphDef ({len(data):,} bytes, "
        f"{cfg.num_layers} layers, width {cfg.hidden_size}) imported in "
        f"{import_s:.2f} s: {n_nodes} nodes; output() at B="
        f"{SAMEDIFF['batch']} T={SAMEDIFF['seq']}: {ms:.3f} ms; over the "
        f"{int(valid.sum())} valid tokens max|sd - encoder| / max|encoder| "
        f"= {err:.3e} (rtol {SAMEDIFF_RTOL:.0e}; "
        f"the encoder launched flash_fwd {enc_launches} times)")
    if not err <= SAMEDIFF_RTOL:
        raise AssertionError(f"samediff: the imported graph differs from "
                             f"the encoder by {err:.3e}")
    if enc_launches != cfg.num_layers:
        raise AssertionError(f"samediff: the encoder launched flash_fwd "
                             f"{enc_launches} times")
    del want
    # fine-tune: every float weight of the graph becomes a variable
    weights = [n for n, v in sd._values.items()
               if v.dtype == torch.float32 and v.ndim >= 1
               and v.numel() >= cfg.num_labels and "/" in n
               and not n.startswith("bert/encoder/shape")]
    sd.convertConstantsToVariables(*weights)
    labels = sd.placeHolder("labels", None, cfg.num_labels)
    sd.loss.softmaxCrossEntropy("loss", labels, sd.getVariable("logits"))
    sd.setLossVariables("loss")
    sd.setTrainingConfig(TrainingConfig.Builder()
                         .updater(Adam(SAMEDIFF["lr"])).build())
    feeds_l = dict(feeds, labels=inputs["labels"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [sd.fit(placeholders=feeds_l)
              for _ in range(SAMEDIFF["steps"])]
    torch.cuda.synchronize()
    fit_ms = (time.perf_counter() - t0) * 1e3 / SAMEDIFF["steps"]
    log(f"[samediff] {SAMEDIFF['steps']} fit steps (Adam "
        f"{SAMEDIFF['lr']}, {len(weights)} variables): {fit_ms:.3f} "
        f"ms/step, losses {[round(v, 5) for v in losses]}")
    if not np.isfinite(losses).all():
        raise AssertionError(f"samediff: a loss is not finite: {losses}")
    # save, reload two ways: outputs bit-identical to the saved graph's
    SAMEDIFF_DIR.mkdir(parents=True, exist_ok=True)
    path = SAMEDIFF_DIR / "bert_base.sdz"
    outs = ["logits", SEQUENCE_OUTPUT]
    try:
        ref = {k: v.tensor.clone() for k, v in sd.output(feeds, outs)
               .items()}
        t0 = time.perf_counter()
        sd.save(str(path))
        save_s = time.perf_counter() - t0
        nbytes = path.stat().st_size
        t0 = time.perf_counter()
        back = load_samediff(str(path))
        load_s = time.perf_counter() - t0
        guess = ModelGuesser.loadModelGuess(str(path))
        same = {}
        for what, g in (("load_samediff", back), ("ModelGuesser", guess)):
            o = g.output(feeds, outs)
            same[what] = all(torch.equal(o[k].tensor, ref[k])
                             for k in outs)
    finally:
        shutil.rmtree(SAMEDIFF_DIR, ignore_errors=True)
    launches = _counts()
    log(f"[samediff] archive {nbytes:,} bytes: save {save_s:.2f} s, load "
        f"{load_s:.2f} s; outputs bit-identical {same}")
    if not all(same.values()):
        raise AssertionError(f"samediff: reloaded outputs differ: {same}")
    if not isinstance(guess, type(sd)):
        raise AssertionError(f"samediff: ModelGuesser gave {type(guess)}")
    ours = {k: n for k, n in launches.items() if n and k != "flash_fwd"}
    if ours or launches["flash_fwd"] != enc_launches:
        raise AssertionError(f"samediff: the SameDiff path launched "
                             f"kernels: {launches}")
    del sd, back, guess
    gc.collect()
    torch.cuda.empty_cache()
    return {"nodes": n_nodes, "graphdef_bytes": len(data),
            "import_s": import_s, "output_ms": ms, "rel_err": err,
            "fit_ms": fit_ms, "losses": losses, "variables": len(weights),
            "archive_bytes": nbytes, "save_s": save_s, "load_s": load_s,
            "bit_identical": same,
            "launches": {k: n for k, n in launches.items()
                         if k != "flash_fwd"}}


# -- ONNX ---------------------------------------------------------------------
#: the onnx phase (`--only onnx`): ResNet-50 written as an ONNX ModelProto
#: from the fused net's seeded weights and BN draws, imported into SameDiff
ONNX = dict(batch=32, size=224, steps=3, lr=1e-4, seed=31)
ONNX_DIR = Path(__file__).resolve().parent / "build" / "onnx"


def onnx_tensor(name, arr):
    """A TensorProto: dims, data_type, name and raw_data (little-endian)."""
    from deeplearning4j_tpu_torch.autodiff.tfproto import (_put_bytes,
                                                           _put_varint)
    arr = np.ascontiguousarray(arr)
    dt = {np.dtype("float32"): 1, np.dtype("int64"): 7,
          np.dtype("int32"): 6}[arr.dtype]
    out = bytearray()
    for d in arr.shape:
        _put_varint(out, 1, d)          # dims
    _put_varint(out, 2, dt)             # data_type
    _put_bytes(out, 8, name.encode())   # name
    _put_bytes(out, 9, arr.tobytes())   # raw_data
    return bytes(out)


def onnx_attr(name, value):
    import struct
    from deeplearning4j_tpu_torch.autodiff.tfproto import (_field, _put_bytes,
                                                           _put_varint)
    out = bytearray()
    _put_bytes(out, 1, name.encode())
    if isinstance(value, float):
        _field(out, 2, 5)
        out.extend(struct.pack("<f", value))
    elif isinstance(value, str):
        _put_bytes(out, 4, value.encode())  # s
    elif isinstance(value, int):
        _put_varint(out, 3, value)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _put_varint(out, 8, int(v))     # ints
    elif isinstance(value, np.ndarray):
        _put_bytes(out, 5, onnx_tensor("", value))  # t
    return bytes(out)


def onnx_node(op, inputs, outputs, name="", **attrs):
    from deeplearning4j_tpu_torch.autodiff.tfproto import _put_bytes
    out = bytearray()
    for i in inputs:
        _put_bytes(out, 1, i.encode())
    for o in outputs:
        _put_bytes(out, 2, o.encode())
    _put_bytes(out, 3, name.encode())
    _put_bytes(out, 4, op.encode())
    for k, v in attrs.items():
        _put_bytes(out, 5, onnx_attr(k, v))
    return bytes(out)


def onnx_value_info(name, dims):
    from deeplearning4j_tpu_torch.autodiff.tfproto import (_put_bytes,
                                                           _put_varint)
    shape = bytearray()
    for d in dims:
        dim = bytearray()
        _put_varint(dim, 1, d)
        _put_bytes(shape, 1, bytes(dim))
    tensor_type = bytearray()
    _put_varint(tensor_type, 1, 1)          # elem_type FLOAT
    _put_bytes(tensor_type, 2, bytes(shape))
    type_proto = bytearray()
    _put_bytes(type_proto, 1, bytes(tensor_type))
    out = bytearray()
    _put_bytes(out, 1, name.encode())
    _put_bytes(out, 2, bytes(type_proto))
    return bytes(out)


def onnx_model(nodes, initializers, inputs, outputs, opset=None):
    """ModelProto bytes (ir_version 7) of NodeProto bytes, {name: array}
    initializers, {name: dims} graph inputs and output names."""
    from deeplearning4j_tpu_torch.autodiff.tfproto import (_put_bytes,
                                                           _put_varint)
    graph = bytearray()
    for n in nodes:
        _put_bytes(graph, 1, n)
    _put_bytes(graph, 2, b"test_graph")
    for name, arr in initializers.items():
        _put_bytes(graph, 5, onnx_tensor(name, arr))
    for name, dims in inputs.items():
        _put_bytes(graph, 11, onnx_value_info(name, dims))
    for name in outputs:
        _put_bytes(graph, 12, onnx_value_info(name, [1]))
    model = bytearray()
    _put_varint(model, 1, 7)                # ir_version
    _put_bytes(model, 7, bytes(graph))      # graph
    if opset is not None:
        osid = bytearray()
        _put_bytes(osid, 1, b"")            # domain = default
        _put_varint(osid, 2, opset)         # version
        _put_bytes(model, 8, bytes(osid))   # opset_import
    return bytes(model)


def graph_onnx(net, batch):
    """The ComputationGraph `net` (NHWC, one input, one softmax output) as
    an opset-13 ONNX ModelProto, NCHW as exporters write it: Conv (OIHW
    weights, explicit pads of the layer's SAME rule), BatchNormalization
    (the running statistics), Relu, MaxPool, Add, GlobalAveragePool,
    Flatten, Gemm and Softmax; every weight a raw_data initializer. The
    input is "input" (batch, C, H, W); the outputs "<output>" (the
    probabilities) and "<output>_logits". Handles the layer and vertex
    kinds ResNet-50 is made of; any other raises."""
    from deeplearning4j_tpu_torch.nn.conf.graph_vertices import \
        ElementWiseVertex
    from deeplearning4j_tpu_torch.nn.conf.layers import (
        ActivationLayer, BatchNormalization, GlobalPoolingLayer,
        SubsamplingLayer)
    conf = net.conf
    (inp,), (out,) = conf.input_names, conf.output_names
    it = conf.input_types[0]
    hw = {inp: (it.height, it.width)}
    nodes, inits = [], {}

    def host(t):
        return t.detach().float().cpu().numpy()

    def emit(op, args, name, layer, **attrs):
        """`op` producing node `name`, through the layer's activation."""
        a = str(getattr(layer, "activation", None) or "identity").lower()
        if a not in ("identity", "relu"):
            raise ValueError(f"graph_onnx: {name}: activation {a!r}")
        y = name if a == "identity" else f"{name}_pre"
        nodes.append(onnx_node(op, args, [y], **attrs))
        if a == "relu":
            nodes.append(onnx_node("Relu", [y], [name]))

    for name in conf.topo_order:
        node = conf.nodes[name]
        if node.kind == "input":
            continue
        ref, ins = node.ref, node.inputs
        if isinstance(ref, ElementWiseVertex) and ref.op == "add":
            nodes.append(onnx_node("Add", ins, [name]))
            hw[name] = hw[ins[0]]
        elif isinstance(ref, ConvolutionLayer):
            h, w = hw[ins[0]]
            (pt, pb), (pl, pr) = ref._explicit_padding(h, w)
            inits[f"{name}_W"] = np.ascontiguousarray(
                host(net._params[name]["W"]).transpose(3, 2, 0, 1))
            args = [ins[0], f"{name}_W"]
            if ref.hasBias:
                inits[f"{name}_b"] = host(net._params[name]["b"])
                args.append(f"{name}_b")
            emit("Conv", args, name, ref, kernel_shape=list(ref.kernelSize),
                 strides=list(ref.stride), dilations=list(ref.dilation),
                 pads=[pt, pl, pb, pr])
            ot = conf.node_output_types[name]
            hw[name] = (ot.height, ot.width)
        elif isinstance(ref, BatchNormalization):
            p, st = net._params[name], net._state[name]
            for k, v in (("gamma", p["gamma"]), ("beta", p["beta"]),
                         ("mean", st["mean"]), ("var", st["var"])):
                inits[f"{name}_{k}"] = host(v)
            emit("BatchNormalization",
                 [ins[0]] + [f"{name}_{k}" for k in ("gamma", "beta",
                                                    "mean", "var")],
                 name, ref, epsilon=float(ref.eps))
            hw[name] = hw[ins[0]]
        elif isinstance(ref, ActivationLayer) and \
                str(ref.activation).lower() == "relu":
            nodes.append(onnx_node("Relu", [ins[0]], [name]))
            hw[name] = hw[ins[0]]
        elif isinstance(ref, SubsamplingLayer) and ref.poolingType == "max":
            h, w = hw[ins[0]]
            pl, pr, pt, pb = ref._pads(h, w)
            nodes.append(onnx_node(
                "MaxPool", [ins[0]], [name],
                kernel_shape=list(ref.kernelSize), strides=list(ref.stride),
                pads=[pt, pl, pb, pr]))
            ot = conf.node_output_types[name]
            hw[name] = (ot.height, ot.width)
        elif isinstance(ref, GlobalPoolingLayer) and \
                str(ref.poolingType).lower() == "avg":
            nodes.append(onnx_node("GlobalAveragePool", [ins[0]],
                                   [f"{name}_gap"]))
            nodes.append(onnx_node("Flatten", [f"{name}_gap"], [name],
                                   axis=1))
        elif isinstance(ref, OutputLayer) and name == out:
            inits[f"{name}_W"] = host(net._params[name]["W"])
            inits[f"{name}_b"] = host(net._params[name]["b"])
            nodes.append(onnx_node("Gemm", [ins[0], f"{name}_W",
                                            f"{name}_b"],
                                   [f"{name}_logits"]))
            nodes.append(onnx_node("Softmax", [f"{name}_logits"], [name],
                                   axis=-1))
        else:
            raise ValueError(f"graph_onnx: {name}: {type(ref).__name__} is "
                             "not in the writer's set")
    return onnx_model(nodes, inits,
                      {inp: [batch, it.channels, it.height, it.width]},
                      [out, f"{out}_logits"], opset=13)


def _fused_resnet(**zoo):
    """ResNet-50 (the zoo's, `zoo` to ResNet50) on the card with the
    conv1x1+BN fusion on and the resnet phase's seeded BN draws."""
    with _fusion(True):
        net = ResNet50(**zoo).init(DEV)
    _perturb_bn(net, RESNET["seed"])
    if len(net._fused_pairs) != EPILOGUE_PAIRS:
        raise AssertionError(f"{len(net._fused_pairs)} fused pairs, "
                             f"expected {EPILOGUE_PAIRS}")
    return net


def phase_onnx():
    """ResNet-50 written as an ONNX ModelProto, imported on the card and
    held to the fused net's forward; 3 fit steps; the archive saved and
    reloaded two ways with bit-identical outputs."""
    with _no_tf32():
        net = _fused_resnet(inputShape=(ONNX["size"], ONNX["size"], 3))
        b = ONNX["batch"]
        rng = np.random.default_rng(ONNX["seed"])
        hw = ONNX["size"]
        x = rng.standard_normal((b, hw, hw, 3)).astype(np.float32)
        y = np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, b)]
        t0 = time.perf_counter()
        data = graph_onnx(net, b)
        write_s = time.perf_counter() - t0
        _reset_counts()
        t0 = time.perf_counter()
        sd = importOnnx(data)
        torch.cuda.synchronize()
        import_s = time.perf_counter() - t0
        n_nodes = len(sd._nodes)
        ops = sum(1 for v in sd._nodes.values()
                  if v.vtype == VariableType.ARRAY)
        feeds = {"input": np.ascontiguousarray(x.transpose(0, 3, 1, 2))}
        got = sd.output(feeds, ["fc"])["fc"].tensor
        ms = time_ms(lambda: sd.output(feeds, ["fc"]), iters=5)
        sd_launches = _counts()
        _reset_counts()
        want = net.output(x).tensor
        torch.cuda.synchronize()
        fwd_launches = _counts()
        err = float((got - want).abs().max() / want.abs().max())
        top1 = int((got.argmax(-1) == want.argmax(-1)).sum())
        log(f"[onnx] ResNet-50 as ONNX (opset 13, {len(data):,} bytes, "
            f"written in {write_s:.2f} s): {n_nodes} nodes ({ops} "
            f"ops), imported in {import_s:.2f} s; output() at B={b}: "
            f"{ms:.3f} ms; max|onnx - fused| / max|fused| = {err:.3e} (rtol "
            f"{RESNET_RTOL:.0e}), top-1 equal on {top1}/{b}; the fused "
            f"forward launched matmul_epilogue "
            f"{fwd_launches['matmul_epilogue']} times")
        if not err <= RESNET_RTOL or top1 != b:
            raise AssertionError(f"onnx: the import differs from the fused "
                                 f"forward: {err:.3e}, top-1 {top1}/{b}")
        if fwd_launches["matmul_epilogue"] != EPILOGUE_PAIRS:
            raise AssertionError(f"onnx: the fused forward launched "
                                 f"{fwd_launches}")
        if any(sd_launches.values()):
            raise AssertionError(f"onnx: the SameDiff path launched "
                                 f"kernels: {sd_launches}")
        del want, got
        # fine-tune: the initializers but BN's running statistics become
        # variables
        weights = [n for n in sd._values if n.endswith(
            ("_W", "_b", "_gamma", "_beta"))]
        sd.convertConstantsToVariables(*weights)
        labels = sd.placeHolder("labels", None, 1000)
        sd.loss.softmaxCrossEntropy("loss", labels,
                                    sd.getVariable("fc_logits"))
        sd.setLossVariables("loss")
        sd.setTrainingConfig(TrainingConfig.Builder()
                             .updater(Adam(ONNX["lr"])).build())
        feeds_l = dict(feeds, labels=y)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = [sd.fit(placeholders=feeds_l)
                  for _ in range(ONNX["steps"])]
        torch.cuda.synchronize()
        fit_ms = (time.perf_counter() - t0) * 1e3 / ONNX["steps"]
        log(f"[onnx] {ONNX['steps']} fit steps (Adam {ONNX['lr']}, "
            f"{len(weights)} variables, B={b}): {fit_ms:.3f} ms/step, "
            f"losses {[round(v, 5) for v in losses]}")
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"onnx: the loss did not fall: {losses}")
        ONNX_DIR.mkdir(parents=True, exist_ok=True)
        path = ONNX_DIR / "resnet50_onnx.sdz"
        try:
            ref = sd.output(feeds, ["fc"])["fc"].tensor.clone()
            t0 = time.perf_counter()
            sd.save(str(path))
            save_s = time.perf_counter() - t0
            nbytes = path.stat().st_size
            t0 = time.perf_counter()
            back = load_samediff(str(path))
            load_s = time.perf_counter() - t0
            guess = ModelGuesser.loadModelGuess(str(path))
            same = {what: torch.equal(g.output(feeds, ["fc"])["fc"].tensor,
                                      ref)
                    for what, g in (("load_samediff", back),
                                    ("ModelGuesser", guess))}
        finally:
            shutil.rmtree(ONNX_DIR, ignore_errors=True)
        log(f"[onnx] archive {nbytes:,} bytes: save {save_s:.2f} s, load "
            f"{load_s:.2f} s; outputs bit-identical {same}")
        if not all(same.values()) or not isinstance(guess, type(sd)):
            raise AssertionError(f"onnx: reloaded outputs differ: {same}, "
                                 f"{type(guess)}")
    del sd, back, guess, net
    gc.collect()
    torch.cuda.empty_cache()
    return {"model_bytes": len(data), "write_s": write_s,
            "nodes": n_nodes, "ops": ops,
            "import_s": import_s, "output_ms": ms, "rel_err": err,
            "top1_equal": top1, "fit_ms": fit_ms, "losses": losses,
            "variables": len(weights), "archive_bytes": nbytes,
            "save_s": save_s, "load_s": load_s, "bit_identical": same,
            "launches": fwd_launches}


# -- spark ----------------------------------------------------------------------
#: the spark phase (`--only spark`): CLASSES × PER_CLASS seeded RGB images
#: at SIZE², written as PNGs in class folders and read back by datavec
#: (decode, the C++ bilinear resize to 224², a flip and a random 192² crop
#: resized back), batched for SparkComputationGraph over fused ResNet-50
SPARK = dict(classes=10, per_class=32, size=256, input=224, crop=192,
             batch=32, epochs=2, slices=4, lr=0.01, seed=37, backend="nccl")
SPARK_DIR = Path(__file__).resolve().parent / "build" / "spark"


def _spark_images():
    """(uint8 images (n, SIZE, SIZE, 3), class ids): each class a seeded
    colour pattern plus noise."""
    s = SPARK
    rng = np.random.default_rng(s["seed"])
    yy, xx = np.mgrid[0:s["size"], 0:s["size"]].astype(np.float32) / s["size"]
    imgs, ids = [], []
    for c in range(s["classes"]):
        phase = c * 2.39996323
        pattern = 0.5 + 0.5 * np.sin((1 + c % 5) * 2 * np.pi * xx + phase) \
            * np.cos((1 + c // 5) * 2 * np.pi * yy + 0.5 * phase)
        colour = rng.uniform(0.3, 1.0, 3).astype(np.float32)
        x = pattern[None, :, :, None] * colour + 0.15 * rng.standard_normal(
            (s["per_class"], s["size"], s["size"], 3), dtype=np.float32)
        imgs.append((np.clip(x, 0, 1) * 255).astype(np.uint8))
        ids += [c] * s["per_class"]
    return np.concatenate(imgs), np.asarray(ids)


def _spark_batches():
    """The images through PNG files and datavec: (DataSets of SPARK
    ["batch"] in [0, 1], host seconds per batch to read them, bytes)."""
    from PIL import Image
    from deeplearning4j_tpu_torch.datasets.normalizers import \
        ImagePreProcessingScaler
    from deeplearning4j_tpu_torch.datavec import (
        FlipImageTransform, ImageRecordDataSetIterator, ImageRecordReader,
        ParentPathLabelGenerator, PipelineImageTransform,
        RandomCropTransform)
    imgs, ids = _spark_images()
    shutil.rmtree(SPARK_DIR, ignore_errors=True)
    for i, (img, c) in enumerate(zip(imgs, ids)):
        d = SPARK_DIR / f"class_{c:02d}"
        d.mkdir(parents=True, exist_ok=True)
        Image.fromarray(img).save(d / f"img_{i:04d}.png")
    png_bytes = sum(p.stat().st_size for p in SPARK_DIR.rglob("*.png"))
    reader = ImageRecordReader(
        SPARK["input"], SPARK["input"], 3, ParentPathLabelGenerator(),
        PipelineImageTransform(FlipImageTransform(),
                               RandomCropTransform(SPARK["crop"],
                                                   SPARK["crop"])),
        seed=SPARK["seed"], nativeLoader=True).initialize(SPARK_DIR,
                                                          shuffle=True)
    it = ImageRecordDataSetIterator(reader, SPARK["batch"],
                                    preprocessor=ImagePreProcessingScaler())
    t0 = time.perf_counter()
    batches = list(it)
    record_s = (time.perf_counter() - t0) / len(batches)
    shutil.rmtree(SPARK_DIR, ignore_errors=True)
    return batches, record_s, png_bytes


def _spark_net():
    hw = SPARK["input"]
    return _fused_resnet(numClasses=SPARK["classes"],
                         updater=Nesterovs(SPARK["lr"], 0.9),
                         inputShape=(hw, hw, 3))


def _net_state(net):
    """(parameters, BN state) of `net`, cloned."""
    return _snapshot(net._params), _snapshot(net._state)


def _same_state(a, b):
    return not any(_equal_trees(x, y) for x, y in zip(a, b))


@contextlib.contextmanager
def _one_rank(backend):
    """A process group of one rank (NCCL on the card) for the span."""
    import socket
    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def phase_spark(batches=None):
    """datavec's image records feeding SparkComputationGraph over fused
    ResNet-50 at one NCCL rank; held to ParallelWrapper bit for bit and to
    ParameterAveragingTrainingMaster; returns (stats, the batches)."""
    from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
    from deeplearning4j_tpu_torch.spark import (
        JavaSparkContext, ParameterAveragingTrainingMaster, SharedTrainingMaster,
        SparkComputationGraph, SparkConf)
    s = SPARK
    if batches is None:
        batches, record_s, png_bytes = _spark_batches()
    else:
        record_s = png_bytes = None
    steps = len(batches)
    with _no_tf32(), _deterministic(), _one_rank(s["backend"]):
        sc = JavaSparkContext(SparkConf().setMaster("local[*]"))
        rdd = sc.parallelize(batches, numSlices=s["slices"])
        shared = (SharedTrainingMaster.Builder(s["batch"])
                  .batchSizePerWorker(s["batch"]).build())
        net = _spark_net()
        spark = SparkComputationGraph(sc, net, shared)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        spark.fit(rdd)                      # epoch 1: eager step, capture
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        _reset_counts()
        prof, _ = _profiled("spark epoch 2", lambda: spark.fit(rdd),
                            groups=PROFILED_TRAIN)
        launches = _counts()
        wall = (prof["wall_ms"] / 1e3 if prof is not None else None)
        per_step = {k: launches[k] / steps for k in TRAIN_KERNELS}
        ev = spark.evaluate(rdd)
        manual = Evaluation()
        for ds in batches:
            manual.eval(ds.labels, net.output(ds.features).numpy())
        eval_same = (ev.accuracy() == manual.accuracy()
                     and np.array_equal(ev.confusionMatrix(),
                                        manual.confusionMatrix()))
        got = _net_state(net)
        score = spark.getScore()
        del spark, net
        gc.collect()
        # the same steps through ParallelWrapper, then the averaging master
        ref = _spark_net()
        (ParallelWrapper.Builder(ref).workers(1)
         .prefetchBuffer(shared.workerPrefetchNumBatches).build()
         .fit(ListDataSetIterator(batches, s["batch"]), epochs=s["epochs"]))
        pw_same = _same_state(got, _net_state(ref))
        del ref
        gc.collect()
        avg = _spark_net()
        pam = (ParameterAveragingTrainingMaster.Builder(s["batch"])
               .batchSizePerWorker(s["batch"]).averagingFrequency(5).build())
        SparkComputationGraph(sc, avg, pam).fit(rdd, epochs=s["epochs"])
        pa_same = _same_state(got, _net_state(avg))
        del avg
        gc.collect()
        torch.cuda.empty_cache()
    b = s["batch"]
    out = {"batches": steps, "record_ms_per_batch": (record_s * 1e3 if
                                                     record_s else None),
           "png_bytes": png_bytes, "first_epoch_s": first_s,
           "ms_per_step": wall * 1e3 / steps if wall else None,
           "images_per_s": b * steps / wall if wall else None,
           "idle_share": prof["idle_share"] if prof else None,
           "launches": launches, "launches_per_step": per_step,
           "score": score, "accuracy": ev.accuracy(),
           "evaluate_equal": eval_same, "wrapper_bit_equal": pw_same,
           "averaging_bit_equal": pa_same}
    rec = (f"{record_s * 1e3:.1f} ms of host record time per batch (PNG "
           f"decode, C++ resize, flip, crop, PIL resize; {png_bytes:,} PNG "
           f"bytes)" if record_s else "batches handed in")
    log(f"[spark] {s['classes']} classes x {s['per_class']} images "
        f"{s['size']}x{s['size']} -> {steps} batches of {b} at "
        f"{s['input']}x{s['input']}: "
        f"{rec}; SparkComputationGraph(SharedTrainingMaster, one "
        f"{s['backend']} rank) over fused ResNet-50, {s['epochs']} epochs of "
        f"{steps} steps: epoch 1 (eager step and capture) {first_s:.2f} s, "
        f"epoch 2 {out['ms_per_step']:.2f} ms/step, "
        f"{out['images_per_s']:.1f} images/s, card idle share "
        f"{out['idle_share']:.4f} (under torch.profiler); launches per "
        f"step {per_step}; evaluate(rdd) accuracy {ev.accuracy():.4f} "
        f"equals Evaluation over net.output {eval_same}; parameters and BN "
        f"state bit-equal to ParallelWrapper's {pw_same}, to "
        f"ParameterAveragingTrainingMaster's {pa_same}")
    wrong = {k: n for k, n in per_step.items() if n != EPILOGUE_PAIRS}
    if wrong:
        raise AssertionError(f"spark: launches per step {wrong}")
    if not (eval_same and pw_same and pa_same and np.isfinite(score)):
        raise AssertionError(f"spark: evaluate {eval_same}, wrapper "
                             f"{pw_same}, averaging {pa_same}, score {score}")
    return out, batches


# -- arbiter --------------------------------------------------------------------
#: the arbiter phase (`--only arbiter`): (a) TPE over fused ResNet-50's
#: Nesterovs rate and momentum on the spark phase's batches, (b) random
#: search over the zoo LeNet's widths fed by a seeded MNIST-shaped CSV
ARBITER = dict(resnet_candidates=4, startup=2, steps=5, tpe_seed=5,
               rows=10_000, held=1_000, lenet_batch=64, lenet_candidates=4,
               random_seed=3)


def _mnist_csv(path):
    """ARBITER["rows"] seeded MNIST-shaped rows (784 pixels 0-255 and a
    label), the port's synthetic MNIST patterns, written as CSV."""
    from deeplearning4j_tpu_torch.datasets.iterators import _synthetic_images
    imgs, y = _synthetic_images(ARBITER["rows"], 28, 28, 1, 10, 123)
    table = np.concatenate([imgs.reshape(len(imgs), -1).astype(np.int64),
                            y[:, None]], axis=1)
    np.savetxt(path, table, fmt="%d", delimiter=",")


def _lenet_space():
    from deeplearning4j_tpu_torch.arbiter import (ContinuousParameterSpace,
                                                  DiscreteParameterSpace,
                                                  LayerSpace, MultiLayerSpace,
                                                  NesterovsSpace)
    return (MultiLayerSpace.Builder().seed(12345).weightInit("xavier")
            .updater(NesterovsSpace(ContinuousParameterSpace(1e-3, 1e-1,
                                                             log=True)))
            .addLayer(LayerSpace(ConvolutionLayer, kernelSize=(5, 5),
                                 stride=(1, 1), nOut=20,
                                 activation="identity"))
            .addLayer(LayerSpace(SubsamplingLayer, poolingType="max",
                                 kernelSize=(2, 2), stride=(2, 2)))
            .addLayer(LayerSpace(ConvolutionLayer, kernelSize=(5, 5),
                                 stride=(1, 1), nOut=50,
                                 activation="identity"))
            .addLayer(LayerSpace(SubsamplingLayer, poolingType="max",
                                 kernelSize=(2, 2), stride=(2, 2)))
            .addLayer(LayerSpace(DenseLayer, activation="relu",
                                 nOut=DiscreteParameterSpace(250, 500, 750)))
            .addLayer(LayerSpace(OutputLayer, nOut=10, activation="softmax",
                                 lossFunction="negativeloglikelihood"))
            .setInputType(InputType.convolutionalFlat(28, 28, 1)).build())


def _replayed(make_gen, results):
    """The candidates a fresh generator yields when fed `results`' scores
    in turn."""
    gen, seq = make_gen(), []
    for r in results:
        c = gen.next_candidate()
        gen.report(c, r.score)
        seq.append(c)
    return seq


def _arbiter_gate(what, runner, make_gen):
    scores = [r.score for r in runner.results]
    best = runner.bestResult()
    replay = _replayed(make_gen, runner.results)
    same = replay == [r.params for r in runner.results]
    log(f"[arbiter] {what}: " + "; ".join(
        f"{r.params} -> {r.score:.5f} in {r.duration_s:.2f} s"
        for r in runner.results) + f"; best {best.params} {best.score:.5f}; "
        f"a second generator fed the same scores yields the same "
        f"candidates {same}")
    if not (np.isfinite(scores).all() and best.score == min(scores)
            and same):
        raise AssertionError(f"arbiter: {what}: scores {scores}, best "
                             f"{best.score}, replay {same}")


def phase_arbiter(batches=None):
    """Hyperparameter search: TPE over fused ResNet-50, random search over
    a LeNet MultiLayerSpace fed by datavec from a CSV."""
    from deeplearning4j_tpu_torch.arbiter import (ContinuousParameterSpace,
                                                  DiscreteParameterSpace,
                                                  LocalOptimizationRunner,
                                                  RandomSearchGenerator,
                                                  TPEGenerator)
    from deeplearning4j_tpu_torch.datasets.normalizers import \
        ImagePreProcessingScaler
    from deeplearning4j_tpu_torch.datavec import (CollectionRecordReader,
                                                  CSVRecordReader,
                                                  RecordReaderDataSetIterator,
                                                  Schema, TransformProcess)
    a = ARBITER
    if batches is None:
        batches = _spark_batches()[0]
    train, held = batches[:a["steps"]], batches[-1]
    space = {"lr": ContinuousParameterSpace(1e-4, 1e-1, log=True),
             "momentum": DiscreteParameterSpace(0.9, 0.95)}

    def make_tpe():
        return TPEGenerator(space, seed=a["tpe_seed"],
                            startupTrials=a["startup"])

    launches = []

    def build(p):
        hw = SPARK["input"]
        return _fused_resnet(numClasses=SPARK["classes"],
                             updater=Nesterovs(p["lr"], p["momentum"]),
                             inputShape=(hw, hw, 3))

    def score(net):
        # the first fit runs eagerly and the second captures the step's
        # graph; the launches are counted over the replays after it
        for ds in train[:2]:
            net.fit(ds)
        torch.cuda.synchronize()
        _reset_counts()
        for ds in train[2:]:
            net.fit(ds)
        torch.cuda.synchronize()
        launches.append({k: v / (len(train) - 2) for k, v in
                         _counts().items() if k in TRAIN_KERNELS})
        return float(net.score(held))

    with _no_tf32():
        runner = LocalOptimizationRunner(make_tpe(), build, score,
                                         maxCandidates=a["resnet_candidates"])
        runner.execute()
        gc.collect()
        torch.cuda.empty_cache()
        _arbiter_gate("TPE over fused ResNet-50 (Nesterovs lr, momentum; "
                      f"{a['steps']} graphed steps a candidate)", runner,
                      make_tpe)
        log(f"[arbiter] launches per replayed step, each candidate: "
            f"{launches}")
        if any(n != EPILOGUE_PAIRS for d in launches for n in d.values()):
            raise AssertionError(f"arbiter: launches per step {launches}")
        resnet = [{"params": r.params, "score": r.score,
                   "s": r.duration_s} for r in runner.results]
        # (b) LeNet over a CSV through CSVRecordReader -> TransformProcess
        # -> RecordReaderDataSetIterator
        tmp = Path(__file__).resolve().parent / "build" / "arbiter"
        tmp.mkdir(parents=True, exist_ok=True)
        csv_path = tmp / "mnist.csv"
        t0 = time.perf_counter()
        _mnist_csv(csv_path)
        rows = list(CSVRecordReader().initialize(str(csv_path)))
        shutil.rmtree(tmp, ignore_errors=True)
        schema = (Schema.Builder()
                  .addColumnsDouble(*[f"p{i}" for i in range(784)])
                  .addColumnCategorical("label", *[str(d) for d in range(10)])
                  .build())
        tp = (TransformProcess.Builder(schema).categoricalToInteger("label")
              .build())
        rows, _ = tp.execute(rows)
        its = []
        for part in (rows[:-a["held"]], rows[-a["held"]:]):
            it = RecordReaderDataSetIterator(CollectionRecordReader(part),
                                             a["lenet_batch"], 784, 10)
            it.setPreProcessor(ImagePreProcessingScaler())
            its.append(it)
        etl_s = time.perf_counter() - t0
        train_it, held_it = its
        held_ds = held_it.next()
        mls = _lenet_space()

        def make_random():
            return RandomSearchGenerator(mls.collectLeaves(),
                                         seed=a["random_seed"])

        def lenet_score(net):
            net.fit(train_it)
            return float(net.score(held_ds))

        lenet = LocalOptimizationRunner(make_random(), mls, lenet_score,
                                        maxCandidates=a["lenet_candidates"])
        _reset_counts()
        lenet.execute()
        lenet_launches = _counts()
        _arbiter_gate(f"random search over LeNet ({a['rows'] - a['held']:,} "
                      f"CSV rows, 1 epoch a candidate; the CSV written, read "
                      f"and transformed in {etl_s:.2f} s)", lenet,
                      make_random)
        if any(lenet_launches.values()):
            raise AssertionError(f"arbiter: LeNet launched {lenet_launches}")
    gc.collect()
    torch.cuda.empty_cache()
    return {"resnet": resnet, "resnet_launches_per_step": launches,
            "launches": {k: int(sum(d[k] for d in launches)
                                * (len(train) - 2)) for k in TRAIN_KERNELS},
            "lenet": [{"params": r.params, "score": r.score,
                       "s": r.duration_s} for r in lenet.results],
            "etl_s": etl_s}


# -- clustering ---------------------------------------------------------------
#: the clustering phase (`--only clustering`): N points of a K-blob mixture
#: at ResNet-50's pooled width D (blob means N(0, 1) per dimension, spread
#: `spread`: k-means++ then seeds one center per blob), k-means, exact kNN
#: of queries drawn around the blob means at `query_spread`, the trees,
#: t-SNE and the nearest-neighbours server
CLUSTER = dict(n=100_000, d=2048, blobs=100, spread=0.02, query_spread=1.0,
               iters=20,
               queries=10_000, k=10, check=256, vp_n=10_000, vp_queries=8,
               kd_n=10_000, kd_queries=32, tsne_n=5_000, tsne_iters=500,
               tsne_block=1_000, tsne_ui_n=300, server_queries=16, seed=41)
#: purity of the clusters against the blobs, and the centers' distance to
#: an f64 Lloyd from the same start (max |Δ| / max |f64 center|)
CLUSTER_PURITY = 0.99
CLUSTER_RTOL = 1e-4
#: kNN against an f64 brute force: each returned neighbour's f64 squared
#: distance within this of the f64 k-th best, relative to max |q|²: the
#: f32 GEMM form ‖q‖² − 2q·x + ‖x‖² carries ~√D·ε·|q|² of noise, and
#: neighbours closer than that are ties
KNN_TIE_RTOL = 5e-6


def _blob_mixture(n, seed, means=None, spread=None):
    """(points (n, D) f32, blob ids) of CLUSTER's mixture, drawn on the
    card from a seeded generator; the blob means too unless given."""
    g = torch.Generator(device=DEV)
    g.manual_seed(seed)
    d, k = CLUSTER["d"], CLUSTER["blobs"]
    if means is None:
        means = torch.randn((k, d), generator=g, device=DEV)
    ids = torch.arange(n, device=DEV) % k
    x = means[ids] + (spread or CLUSTER["spread"]) * torch.randn(
        (n, d), generator=g, device=DEV)
    return x, ids, means


def _against_f64(picks, q, items):
    """(identical index sets, worst pick's f64 squared distance past the
    f64 k-th best, the tie tolerance) of (Q, k) neighbour indices of
    queries `q` among `items`, against an f64 brute force."""
    picks = torch.as_tensor(np.asarray(picks), device=items.device)
    d64 = torch.cdist(q.double(), items.double()).square()
    best = torch.topk(d64, picks.shape[1], largest=False)
    worse = float((torch.gather(d64, 1, picks) - best.values[:, -1:]).max())
    exact = int((torch.sort(picks)[0] == torch.sort(best.indices)[0])
                .all(-1).sum())
    return exact, worse, KNN_TIE_RTOL * float(q.double().square().sum(-1)
                                              .max())


def _kl(p_cond, y, n):
    """KL(P ‖ Q) of embedding `y` (n rows) under the conditional P."""
    p = p_cond[:n, :n]
    p = torch.clamp((p + p.T) / (2.0 * n), min=1e-12)
    d2 = torch.cdist(y, y).square()
    num = 1.0 / (1.0 + d2)
    num.fill_diagonal_(0.0)
    q = torch.clamp(num / num.sum(), min=1e-12)
    off = ~torch.eye(n, dtype=torch.bool, device=y.device)
    return float((p * torch.log(p / q))[off].sum())


def _clustering_kmeans(x_np, ids):
    from deeplearning4j_tpu_torch.clustering import kmeans as km
    c = CLUSTER
    kmc = KMeansClustering.setup(c["blobs"], c["iters"], "euclidean",
                                 useKMeansPlusPlus=True, seed=c["seed"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cs = kmc.applyTo(x_np)
    apply_s = time.perf_counter() - t0
    # the device loop alone from the same seeding, run to its count
    # (applyTo stops at the first iteration that moves no point), timed
    # per iteration, and the same loop in f64
    x = torch.as_tensor(x_np, device=DEV)
    c0 = kmc.initialCenters(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    centers, assign, iters = km._lloyd(x, c0, c["blobs"], "euclidean",
                                       c["iters"], -1.0)
    torch.cuda.synchronize()
    lloyd_ms = (time.perf_counter() - t0) * 1e3 / max(iters, 1)
    c64, a64, it64 = km._lloyd(x.double(), c0.double(), c["blobs"],
                               "euclidean", c["iters"], -1.0)
    rel = float((centers.double() - c64).abs().max() / c64.abs().max())
    same_assign = bool(torch.equal(assign, a64))
    ids_np = ids.cpu().numpy()
    pure = 0
    for cl in cs.getClusters():
        members = np.asarray([int(p.getId()) for p in cl.getPoints()],
                             np.int64)
        if members.size:
            pure += np.bincount(ids_np[members]).max()
    purity = pure / len(ids_np)
    sizes = sorted(len(cl.getPoints()) for cl in cs.getClusters())
    log(f"[clustering] KMeansClustering.setup({c['blobs']}, {c['iters']}, "
        f"'euclidean', k-means++) on {len(x_np):,} x {c['d']} f32 "
        f"({x_np.nbytes:,} bytes): applyTo {apply_s:.2f} s ({kmc.iterations}"
        f" Lloyd iterations to convergence); {iters} iterations run to the "
        f"count at {lloyd_ms:.3f} ms each; purity {purity:.4f} (gate "
        f">= {CLUSTER_PURITY}), cluster sizes {sizes[0]}..{sizes[-1]}; from "
        f"the same start an f64 Lloyd ({it64} iterations): centers "
        f"{rel:.3e} (rtol {CLUSTER_RTOL:.0e}), assignments equal "
        f"{same_assign}")
    if not purity >= CLUSTER_PURITY:
        raise AssertionError(f"clustering: purity {purity:.4f}")
    if not rel <= CLUSTER_RTOL or it64 != iters or not same_assign:
        raise AssertionError(f"clustering: Lloyd differs from f64: {rel:.3e}"
                             f", iterations {iters} vs {it64}")
    return {"apply_s": apply_s, "apply_iterations": kmc.iterations,
            "lloyd_iterations": iters,
            "lloyd_ms_per_iteration": lloyd_ms, "purity": purity,
            "f64_rel": rel, "cluster_sizes": [sizes[0], sizes[-1]]}


def _clustering_knn(x, means):
    c = CLUSTER
    q, _, _ = _blob_mixture(c["queries"], c["seed"] + 1, means,
                            c["query_spread"])
    knn(q[:64], x, c["k"])                     # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx, dist = knn(q, x, c["k"])
    knn_ms = (time.perf_counter() - t0) * 1e3
    exact, worse, tol = _against_f64(idx[:c["check"]], q[:c["check"]], x)
    log(f"[clustering] knn: {c['queries']:,} queries x {len(x):,} points, "
        f"k={c['k']}: {knn_ms:.2f} ms; against an f64 brute force on "
        f"{c['check']} queries: {exact} identical index sets, the worst "
        f"pick {worse:.3e} past the f64 k-th best (tie tolerance "
        f"{tol:.3e})")
    if not worse <= tol:
        raise AssertionError(f"clustering: knn picked a neighbour "
                             f"{worse:.3e} beyond the f64 k-th best")
    return q, {"knn_ms": knn_ms, "exact_sets": exact, "worst_pick": worse,
               "tie_tol": tol}


def _clustering_trees(x, q):
    c = CLUSTER
    sub = x[:c["vp_n"]].cpu().numpy()
    t0 = time.perf_counter()
    tree = VPTree(sub)
    build_s = time.perf_counter() - t0
    queries = q[:c["vp_queries"]].cpu().numpy()
    want, _ = knn(queries, sub, c["k"])
    t0 = time.perf_counter()
    got = [[r.getIndex() for r in tree.search(v, c["k"])[0]]
           for v in queries]
    search_ms = (time.perf_counter() - t0) * 1e3 / len(queries)
    same = sum(g == w for g, w in zip(got, want.tolist()))
    # the tree's exact f32 distances and knn's GEMM form may order
    # neighbours within f32 noise differently: both held to f64
    checks = [_against_f64(p, q[:c["vp_queries"]], x[:c["vp_n"]])
              for p in (got, want)]
    vp_equal = all(worse <= tol for _, worse, tol in checks)
    rng = np.random.default_rng(c["seed"])
    pts = rng.normal(size=(c["kd_n"], 3)).astype(np.float32)
    kd = KDTree(3)
    for p in pts:
        kd.insert(p)
    kd_equal = True
    for v in rng.normal(size=(c["kd_queries"], 3)).astype(np.float32):
        d = ((pts.astype(np.float64) - v) ** 2).sum(-1)
        brute = pts[np.argsort(d, kind="stable")[:c["k"]]]
        kd_equal &= bool(np.array_equal(
            np.stack([p for p, _ in kd.knn(v, c["k"])]), brute))
    log(f"[clustering] VPTree over {c['vp_n']:,} x {c['d']}: built in "
        f"{build_s:.2f} s, {search_ms:.1f} ms a search; {same} of "
        f"{c['vp_queries']} searches identical to knn; against an f64 "
        f"brute force (identical sets, worst pick past the k-th best, tie "
        f"tolerance) VPTree {checks[0]}, knn {checks[1]}; KDTree at D=3 "
        f"over {c['kd_n']:,} "
        f"points: {c['kd_queries']} queries equal a brute force {kd_equal}")
    if not (vp_equal and kd_equal):
        raise AssertionError(f"clustering: trees differ: VPTree {vp_equal}, "
                             f"KDTree {kd_equal}")
    return {"vp_build_s": build_s, "vp_search_ms": search_ms,
            "vp_identical_to_knn": same, "vp_against_f64": checks[0]}


def _clustering_tsne(x):
    from deeplearning4j_tpu_torch.clustering import tsne as ts
    from deeplearning4j_tpu_torch.ops.random import normal, seed_key
    c = CLUSTER
    n = c["tsne_n"]
    sub = x[:n].cpu().numpy()
    b = (BarnesHutTsne.Builder().setMaxIter(c["tsne_iters"]).perplexity(30)
         .rowBlockSize(c["tsne_block"]).seed(c["seed"]).build())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = b.fit(sub).getData()
    torch.cuda.synchronize()
    tsne_s = time.perf_counter() - t0
    # KL(P ‖ Q) at the start and at the end, under fit's own P
    xs = (sub - sub.mean(0)) / np.maximum(sub.std(0), 1e-12)
    p = ts._calibrated_p_rows(torch.as_tensor(xs, device=DEV), 30.0, n,
                              c["tsne_block"])
    y0 = 1e-4 * normal(seed_key(c["seed"]), (n, 2), DEV)
    kl0, kl1 = _kl(p, y0, n), _kl(p, torch.as_tensor(y, device=DEV), n)
    ui = UIServer()
    pts3 = x[:c["tsne_ui_n"], :3].cpu().numpy()
    ui.attachTsne(pts3, labels=[str(i) for i in range(len(pts3))],
                  maxIter=300, perplexity=10.0)
    shown = np.asarray(ui._tsne["points"])
    log(f"[clustering] BarnesHutTsne on {n:,} x {c['d']}, "
        f"{c['tsne_iters']} iterations, row block {c['tsne_block']}: "
        f"{tsne_s:.2f} s; KL {kl0:.4f} -> {kl1:.4f}; attachTsne of "
        f"{len(pts3)} 3-D vectors: {shown.shape} finite "
        f"{bool(np.isfinite(shown).all())}")
    if not (np.isfinite(y).all() and kl1 < kl0):
        raise AssertionError(f"clustering: t-SNE's KL did not fall: {kl0} "
                             f"-> {kl1}")
    if shown.shape != (len(pts3), 2) or not np.isfinite(shown).all():
        raise AssertionError(f"clustering: attachTsne gave {shown.shape}")
    return {"tsne_s": tsne_s, "kl_start": kl0, "kl_end": kl1}


def _clustering_server(x_np, q):
    c = CLUSTER
    srv = NearestNeighborsServer(x_np, port=0).start()
    try:
        vecs = q[:c["server_queries"]].cpu().numpy()
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/knnnew",
            json.dumps({"arr": vecs.tolist(), "k": c["k"]}).encode(),
            {"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=120) as r:
            res = json.loads(r.read())["results"]
        http_ms = (time.perf_counter() - t0) * 1e3
    finally:
        srv.stop()
    want, _ = knn(vecs, x_np, c["k"])
    equal = [[e["index"] for e in row] for row in res] == want.tolist()
    log(f"[clustering] NearestNeighborsServer over loopback: "
        f"{c['server_queries']} queries in one POST /knnnew, {http_ms:.1f} "
        f"ms; answers equal knn {equal}")
    if not equal:
        raise AssertionError("clustering: the server's answers differ")
    return {"server_ms": http_ms}


def phase_clustering():
    """k-means, exact kNN, the trees, t-SNE and the nearest-neighbours
    server at ResNet-50's pooled width, N = CLUSTER["n"]."""
    c = CLUSTER
    with _no_tf32():
        torch.cuda.reset_peak_memory_stats()
        x, ids, means = _blob_mixture(c["n"], c["seed"])
        x_np = x.cpu().numpy()
        out = _clustering_kmeans(x_np, ids)
        q, k = _clustering_knn(x, means)
        out.update(k)
        out.update(_clustering_trees(x, q))
        out.update(_clustering_tsne(x))
        out.update(_clustering_server(x_np, q))
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
        log(f"[clustering] peak allocated {out['peak_bytes']:,} bytes")
    del x, x_np, q
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -- nlp ----------------------------------------------------------------------
#: the nlp phase (`--only nlp`): embeddings at their published widths on
#: seeded corpora. `types` word types of Zipf counts (each at least
#: `floor`, so minWordFrequency(5) keeps them all: text8 keeps 71,290),
#: ~`tokens` tokens in single-topic sentences of `sent_len` (type r in
#: topic r % topics); SGNS on a corpus of the same types and topics at
#: ~`sgns_tokens` (a depth cut: its step loop is host-bound, and its
#: gates held at 0.71 M tokens on the CPU: cosine within a topic 0.979,
#: across 0.675); `sub_tokens` of them (the first sentences) for the
#: HS and FastText arms, `glove_tokens` for GloVe; PV's `pv_docs`
#: single-topic documents of `pv_len` tokens; a graph of BlogCatalog's
#: counts in `communities` blocks (`within` of the edges inside one);
#: Kim's CNN on `kim_sentences` labelled sentences of `kim_len` tokens
NLP = dict(types=71_000, tokens=1_500_000, sgns_tokens=750_000, floor=5,
           topics=50, sent_len=20,
           seed=43, d=300, window=5, negative=5, sample=1e-3, lr=0.025,
           min_count=5, batch=1024, sub_tokens=400_000, buckets=2_000_000,
           min_n=3, max_n=6, glove_tokens=300_000, glove_window=10,
           glove_xmax=100.0, glove_alpha=0.75, pv_docs=1_000, pv_len=230,
           pv_d=400, pv_window=10, pv_probe=20, vertices=10_312,
           edges=333_983, communities=39, within=0.85, dw_d=128,
           dw_window=10, dw_walk=40, kim_sentences=10_662, kim_len=20,
           kim_maps=100, kim_windows=(3, 4, 5), kim_batch=50, kim_epochs=2,
           top=1_000, sim_pairs=20_000)
#: one step on the card against the same step through the port on the
#: CPU, relative to the largest table entry; the infer step sums
#: 128·(1 + K) gathered rows into one vector (tests/test_torch_nlp.py's
#: INFER_RTOL)
NLP_STEP_RTOL = 1e-6
NLP_INFER_RTOL = 5e-6
#: Kim's CNN: output() on the card against the same net on the CPU
NLP_CNN_RTOL = 1e-5
NLP_DIR = Path(__file__).resolve().parent / "build" / "nlp"


def _nlp_words(n, seed):
    """`n` distinct seeded lowercase words of 4–10 letters."""
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    out, seen = [], set()
    while len(out) < n:
        w = "".join(rng.choice(letters, int(rng.integers(4, 11))))
        if w not in seen:
            seen.add(w)
            out.append(w)
    return out


def nlp_corpus(c=None):
    """(sentences, words, topic of each word, counts): NLP's Zipf corpus,
    each type `floor` times plus its Zipf share of the rest, shuffled into
    single-topic sentences."""
    c = c or NLP
    words = _nlp_words(c["types"], c["seed"])
    r = np.arange(1, c["types"] + 1, dtype=np.float64)
    extra = c["tokens"] - c["floor"] * c["types"]
    counts = c["floor"] + np.floor(extra * (1 / r) / (1 / r).sum()).astype(
        np.int64)
    rng = np.random.default_rng(c["seed"] + 1)
    topic = np.arange(c["types"]) % c["topics"]
    sents = []
    for t in range(c["topics"]):
        ids = np.repeat(np.flatnonzero(topic == t), counts[topic == t])
        rng.shuffle(ids)
        for s in range(0, len(ids), c["sent_len"]):
            sents.append(" ".join(words[i] for i in ids[s:s + c["sent_len"]]))
    sents = [sents[i] for i in rng.permutation(len(sents))]
    return sents, words, topic, counts


def _topic_draws(words, topic, counts, t, n, rng):
    """`n` words of topic `t`, drawn by the corpus's counts."""
    ids = np.flatnonzero(topic == t)
    p = counts[ids] / counts[ids].sum()
    return [words[i] for i in rng.choice(ids, n, p=p)]


def _prefix(sents, tokens):
    """The first sentences holding about `tokens` tokens."""
    out, n = [], 0
    for s in sents:
        if n >= tokens:
            break
        out.append(s)
        n += s.count(" ") + 1
    return out


def _tap_clone(x):
    if torch.is_tensor(x):
        return x.detach().clone()
    if isinstance(x, dict):
        return {k: _tap_clone(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_tap_clone(v) for v in x)
    return x


@contextlib.contextmanager
def _tapped(module, name, keep=True):
    """Count the calls of module.<name> and keep a copy of the first
    call's arguments (its tables included) and of its result."""
    real = getattr(module, name)
    tap = {"calls": 0, "first": None, "seconds": 0.0}

    def wrapper(*a, **kw):
        if keep and tap["first"] is None:
            tap["first"] = _tap_clone(a)
        tap["calls"] += 1
        return real(*a, **kw)

    setattr(module, name, wrapper)
    try:
        yield tap
    finally:
        setattr(module, name, real)


@contextlib.contextmanager
def _host_timed(obj, *names):
    """Time the calls of obj.<name> for each name (a generator method
    counts the time spent producing its items): the arm's host work."""
    tap = {"seconds": 0.0, "results": {}}
    real = {n: getattr(obj, n) for n in names}

    def timed(fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            tap["seconds"] += time.perf_counter() - t0
            if not hasattr(out, "__next__"):
                tap["results"][fn.__name__] = out
                return out

            def gen():
                while True:
                    t0 = time.perf_counter()
                    try:
                        item = next(out)
                    except StopIteration:
                        tap["seconds"] += time.perf_counter() - t0
                        return
                    tap["seconds"] += time.perf_counter() - t0
                    yield item
            return gen()
        return call

    for n, fn in real.items():
        setattr(obj, n, timed(fn))
    try:
        yield tap
    finally:
        for n in names:
            delattr(obj, n)


def _nlp_fit(name, model, fit, host, taps, pairs=None):
    """Run `fit` for `model` with its host work timed; the figures of the
    arm: host seconds, the rest of the wall (the step loop: launches, the
    batches' copies, the device), steps, steps/s, pairs/s (the pairs
    `_pairs` made, else `pairs`), peak bytes."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _host_timed(model, *host) as ht:
        fit()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    loop = max(wall - ht["seconds"], 1e-9)
    if "_pairs" in ht["results"]:
        pairs = len(ht["results"]["_pairs"][0])
    steps = sum(t["calls"] for t in taps)
    out = {"wall_s": wall, "host_s": ht["seconds"], "loop_s": loop,
           "steps": steps, "steps_per_s": steps / loop,
           "peak_bytes": torch.cuda.max_memory_allocated()}
    if pairs is not None:
        out["pairs"] = pairs
        out["pairs_per_s"] = pairs / loop
    log(f"[nlp] {name}: wall {wall:.2f} s, host {ht['seconds']:.2f} s "
        f"({', '.join(host)}), step loop {loop:.2f} s, {out['steps']} steps "
        f"({out['steps_per_s']:.1f}/s"
        + (f", {pairs:,} pairs, {out['pairs_per_s']:,.0f} pairs/s"
           if pairs is not None else "")
        + f"), peak allocated {out['peak_bytes']:,} bytes")
    return out


def _topic_cosines(table, ids, topic, n, seed):
    """(mean cosine of `n` random same-topic pairs among `ids`, of `n`
    cross-topic pairs)."""
    x = torch.as_tensor(np.asarray(table)[ids], dtype=torch.float64)
    x = x / x.norm(dim=1, keepdim=True).clamp_min(1e-12)
    rng = np.random.default_rng(seed)
    a, b = rng.integers(0, len(ids), (2, 4 * n))
    keep = a != b
    a, b = a[keep], b[keep]
    same = topic[ids[a]] == topic[ids[b]]
    cos = (x[a] * x[b]).sum(1).numpy()
    return float(cos[same][:n].mean()), float(cos[~same][:n].mean())


def _step_on_both(kind, step, tables, args, hist=None):
    """One `step` from `tables` on the card, again from the same tables,
    and once through the port on the CPU: (largest relative difference of
    the tables card vs CPU, bit-identical on the card, the batch repeats
    ids)."""
    def run(dev):
        p = {k: v.to(dev, copy=True) for k, v in tables.items()}
        a = [x.to(dev, copy=True) if torch.is_tensor(x) else x for x in args]
        if kind == "infer":
            return {"vec": step(p["vec"], p["syn1"], *a)}
        if hist is None:
            step(p, *a)
        else:
            step(p, {k: v.to(dev, copy=True) for k, v in hist.items()}, *a)
        return p
    one, two = run(DEV), run(DEV)
    cpu = run("cpu")
    same = all(torch.equal(one[k], two[k]) for k in one)
    rel = max(float((one[k].cpu() - cpu[k]).abs().max()
                    / cpu[k].abs().max().clamp_min(1e-30)) for k in cpu)
    ids = [x for x in args if torch.is_tensor(x) and not x.is_floating_point()]
    repeats = any(torch.unique(x).numel() < x.numel() for x in ids)
    return rel, same, repeats


def _nlp_step_check(name, kind, step, tap, hist_key=None):
    """The arm's first step, from the tables it started with, on the card
    twice and on the CPU."""
    a = tap["first"]
    if kind == "infer":
        vec, syn1, rest = a[0], a[1], list(a[2:])
        rel, same, rep = _step_on_both(kind, step, {"vec": vec, "syn1": syn1},
                                       rest)
    elif hist_key:
        rel, same, rep = _step_on_both(kind, step, a[0], list(a[2:]),
                                       hist=a[1])
    else:
        rel, same, rep = _step_on_both(kind, step, a[0], list(a[1:]))
    tol = NLP_INFER_RTOL if kind == "infer" else NLP_STEP_RTOL
    log(f"[nlp] {name} step, card against the CPU: {rel:.3e} of the "
        f"largest table entry (rtol {tol:.0e}); repeated on the card "
        f"bit-identical {same}; the batch repeats ids {rep}")
    if not (rel <= tol and same and rep):
        raise AssertionError(f"nlp: the {name} step: {rel:.3e}, "
                             f"bit-identical {same}, repeats {rep}")
    return {"rel": rel, "bit_identical": same}


def _held_loss(step, tables, args, hist=None):
    """The loss `step` returns on `args` at `tables` (computed before its
    update, on copies)."""
    p = {k: v.clone() for k, v in tables.items()}
    if hist is None:
        return float(step(p, *args))
    return float(step(p, {k: v.clone() for k, v in hist.items()}, *args))


def _nlp_word2vec(sents, topic_of, hs):
    c = NLP
    name = "Word2Vec HS" if hs else "Word2Vec SGNS"
    corpus = _prefix(sents, c["sub_tokens"]) if hs else sents
    m = (Word2Vec.Builder().minWordFrequency(c["min_count"])
         .layerSize(c["d"]).windowSize(c["window"])
         .negativeSample(c["negative"]).sampling(c["sample"])
         .learningRate(c["lr"]).batchSize(c["batch"]).seed(c["seed"])
         .useHierarchicSoftmax(hs).iterate(corpus).device(DEV).build())
    fn = "_hs_step" if hs else "_sgns_step"
    with _tapped(nlp_w2v, fn) as tap:
        out = _nlp_fit(name, m, m.fit, ("_tokenized", "_pairs", "_batches"),
                       [tap])
    out.update(vocab=m.vocabSize(),
               tokens=sum(s.count(" ") + 1 for s in corpus))
    first = tap["first"]
    step = getattr(nlp_w2v, fn)
    loss0 = _held_loss(step, first[0], first[1:])
    loss1 = _held_loss(step, m.params, first[1:])
    ids = np.asarray([m.vocab.indexOf(w) for w in m.vocab.idx2word[:c["top"]]])
    word_topic = np.asarray([topic_of[w] for w in m.vocab.idx2word])
    within, across = _topic_cosines(m._table(), ids, word_topic,
                                    c["sim_pairs"], c["seed"])
    depth = (int(m._hs_tables[2].sum(1).max()) if hs else None)
    log(f"[nlp] {name}: {out['tokens']:,} tokens, vocabulary "
        f"{out['vocab']:,} (minWordFrequency {c['min_count']}), D = "
        f"{c['d']}, window {c['window']}, "
        + (f"Huffman depth {depth}, " if hs else
           f"negative {c['negative']}, ")
        + f"sample {c['sample']}, lr {c['lr']}, batch {c['batch']}: the "
        f"first batch's loss {loss0:.4f} -> {loss1:.4f}; the {c['top']} "
        f"most frequent words' cosine within a topic {within:.4f}, across "
        f"{across:.4f}")
    if not (loss1 < loss0 and within > across):
        raise AssertionError(f"nlp: {name}: loss {loss0} -> {loss1}, "
                             f"cosine within {within} across {across}")
    out.update(loss_first=loss0, loss_last=loss1, cos_within=within,
               cos_across=across, huffman_depth=depth,
               step_check=_nlp_step_check(name, "hs" if hs else "sgns",
                                          step, tap))
    return m, out


def _nlp_fasttext(sents, words):
    c = NLP
    corpus = _prefix(sents, c["sub_tokens"])
    m = (FastText.Builder().minWordFrequency(c["min_count"])
         .layerSize(c["d"]).windowSize(c["window"])
         .negativeSample(c["negative"]).sampling(c["sample"])
         .learningRate(c["lr"]).batchSize(c["batch"]).seed(c["seed"])
         .bucket(c["buckets"]).minN(c["min_n"]).maxN(c["max_n"])
         .iterate(corpus).device(DEV).build())
    with _tapped(nlp_ft, "_ft_step") as tap:
        out = _nlp_fit("FastText", m, m.fit, ("_tokenized", "_pairs",
                                              "_batches", "_ngram_rows"),
                       [tap])
    # an OOV word: a vocabulary word of 7 or more letters with an "s"
    stem = next(w for w in m.vocab.idx2word[100:]
                if len(w) >= 7 and not m.hasWord(w + "s"))
    vec = m.getWordVector(stem + "s")
    near = m.wordsNearest(vec, 3)
    table_bytes = m.params["syn0"].numel() * 4
    log(f"[nlp] FastText: {len(corpus):,} sentences, vocabulary "
        f"{m.vocabSize():,}, D = {c['d']}, n-grams {c['min_n']}–"
        f"{c['max_n']}, {c['buckets']:,} buckets (table "
        f"{tuple(m.params['syn0'].shape)}, {table_bytes:,} bytes, drawn in "
        f"row chunks): OOV {stem + 's'!r} finite "
        f"{bool(np.isfinite(vec).all())}, nearest {near}")
    if not (np.isfinite(vec).all() and near[0] == stem):
        raise AssertionError(f"nlp: FastText OOV {stem}s nearest {near}")
    out.update(vocab=m.vocabSize(), table_bytes=table_bytes, oov=stem + "s",
               oov_nearest=near,
               step_check=_nlp_step_check("FastText", "ft", nlp_ft._ft_step,
                                          tap))
    del m, tap
    return out


def _nlp_glove(sents):
    c = NLP
    corpus = _prefix(sents, c["glove_tokens"])
    m = (Glove.Builder().layerSize(c["d"]).windowSize(c["glove_window"])
         .xMax(c["glove_xmax"]).alpha(c["glove_alpha"]).epochs(1)
         .seed(c["seed"]).iterate(corpus).device(DEV).build())
    with _tapped(nlp_glove, "_glove_step") as tap:
        out = _nlp_fit("GloVe", m, m.fit, ("_cooccurrences",), [tap])
    first = tap["first"]
    pairs = len(tap["first"][3]) * tap["calls"]
    loss0 = _held_loss(nlp_glove._glove_step, first[0], first[2:],
                       hist=first[1])
    loss1 = _held_loss(nlp_glove._glove_step, m.params, first[2:],
                       hist=m.hist)
    log(f"[nlp] GloVe: {len(corpus):,} sentences, vocabulary "
        f"{m.vocab.numWords():,}, D = {c['d']}, window "
        f"{c['glove_window']}, xMax {c['glove_xmax']}, alpha "
        f"{c['glove_alpha']}, {pairs:,} co-occurrence slots in batches of "
        f"{m.b._batch} ({pairs / out['loop_s']:,.0f} a second of the step "
        f"loop): the first batch's mean weighted loss {loss0:.4f} -> "
        f"{loss1:.4f}")
    if not loss1 < loss0:
        raise AssertionError(f"nlp: GloVe loss {loss0} -> {loss1}")
    out.update(vocab=m.vocab.numWords(), pairs=pairs,
               pairs_per_s=pairs / out["loop_s"], loss_first=loss0,
               loss_last=loss1,
               step_check=_nlp_step_check("GloVe", "glove",
                                          nlp_glove._glove_step, tap,
                                          hist_key=True))
    return out


def _nlp_paragraphs(words, topic, counts):
    """PV-DBOW and PV-DM on single-topic documents. The documents are
    draws from their topic's distribution, told apart by sampling noise
    alone, so what `nearestLabels` can recover is the topic: PV-DBOW's
    gate is that the 5 labels it returns for each training document are
    documents of that document's topic. The own label's presence is
    printed. PV-DM's step averages over its batch (the JAX package's
    `_pvdm_step`), so its document vectors move ~B times less an epoch
    than PV-DBOW's: its gate is its loss, its labels are printed."""
    c = NLP
    rng = np.random.default_rng(c["seed"] + 2)
    docs, doc_topic = [], {}
    for i in range(c["pv_docs"]):
        t = int(rng.integers(c["topics"]))
        docs.append((f"DOC_{i}", " ".join(_topic_draws(
            words, topic, counts, t, c["pv_len"], rng))))
        doc_topic[f"DOC_{i}"] = t
    probes = [docs[i] for i in rng.choice(len(docs), c["pv_probe"],
                                          replace=False)]
    out = {}
    for algo in ("PV-DBOW", "PV-DM"):
        m = (ParagraphVectors.Builder().layerSize(c["pv_d"])
             .windowSize(c["pv_window"]).negativeSample(c["negative"])
             .learningRate(c["lr"]).batchSize(c["batch"]).seed(c["seed"])
             .sequenceLearningAlgorithm(algo).iterate(docs).device(DEV)
             .build())
        with _tapped(nlp_pv, "_sgns_step") as dbow_tap, \
                _tapped(nlp_w2v, "_sgns_step", keep=False) as words_tap, \
                _tapped(nlp_pv, "_pvdm_step") as dm_tap:
            arm = _nlp_fit(algo, m, m.fit, ("_tokenized", "_pairs",
                                            "_batches", "_dm_rows"),
                           [dbow_tap, words_tap, dm_tap])
        dm = algo == "PV-DM"
        doc_tap = dm_tap if dm else dbow_tap
        doc_step = nlp_pv._pvdm_step if dm else nlp_pv._sgns_step
        first = doc_tap["first"]
        loss0 = _held_loss(doc_step, first[0], first[1:])
        loss1 = _held_loss(doc_step, dict(m.params) if dm else {
            "syn0": m.params["docs"], "syn1": m.params["syn1"]}, first[1:])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        own = topical = 0
        with _tapped(nlp_pv, "_infer_step") as infer_tap:
            for lab, text in probes:
                near = m.nearestLabels(text, 5)
                own += lab in near
                topical += all(doc_topic[x] == doc_topic[lab] for x in near)
        torch.cuda.synchronize()
        probe_s = time.perf_counter() - t0
        log(f"[nlp] {algo}: {len(docs):,} documents of {c['pv_len']} "
            f"tokens in {c['topics']} topics, vocabulary {m.vocabSize():,}, "
            f"D = {c['pv_d']}, window {c['pv_window']}, {arm['steps']} "
            f"steps ({words_tap['calls']} word, {doc_tap['calls']} "
            f"document); the first document batch's loss {loss0:.4f} -> "
            f"{loss1:.4f}; nearestLabels of {len(probes)} training "
            f"documents ({probe_s:.2f} s, {infer_tap['calls']} infer steps): "
            f"all 5 of the document's topic for {topical}, the own label "
            f"among them for {own}")
        if not (loss1 < loss0 and (dm or topical == len(probes))):
            raise AssertionError(f"nlp: {algo}: loss {loss0} -> {loss1}, "
                                 f"topical {topical} of {len(probes)}")
        arm.update(loss_first=loss0, loss_last=loss1, own=own,
                   topical=topical, probes=len(probes), probe_s=probe_s,
                   vocab=m.vocabSize())
        if dm:
            arm["step_check"] = _nlp_step_check(
                "PV-DM", "pvdm", nlp_pv._pvdm_step, dm_tap)
        arm["infer_check"] = _nlp_step_check(
            f"{algo} infer", "infer", nlp_pv._infer_step, infer_tap)
        out[algo] = arm
        del m
    return out


def nlp_graph(c=None):
    """A graph of `vertices` and `edges` (undirected, distinct, no
    self-loops) in `communities` blocks, `within` of the edges inside a
    block: (Graph, each vertex's block)."""
    c = c or NLP
    n, k = c["vertices"], c["communities"]
    rng = np.random.default_rng(c["seed"] + 3)
    block = np.arange(n) % k
    members = [np.flatnonzero(block == b) for b in range(k)]
    seen, edges = set(), []
    n_in = int(round(c["edges"] * c["within"]))
    while len(edges) < c["edges"]:
        inside = len(edges) < n_in
        m = 4096
        if inside:
            b = rng.integers(k, size=m)
            u = np.array([members[x][rng.integers(len(members[x]))]
                          for x in b])
            v = np.array([members[x][rng.integers(len(members[x]))]
                          for x in b])
        else:
            u, v = rng.integers(n, size=(2, m))
        for a, z in zip(u.tolist(), v.tolist()):
            key = (min(a, z), max(a, z))
            if a == z or key in seen or (inside and len(edges) >= n_in) \
                    or len(edges) >= c["edges"]:
                continue
            seen.add(key)
            edges.append(key)
    g = Graph(n, allow_multiple_edges=True)   # edges are distinct already
    for a, z in edges:
        g.addEdge(a, z)
    return g, block


def _nlp_deepwalk():
    c = NLP
    t0 = time.perf_counter()
    g, block = nlp_graph()
    graph_s = time.perf_counter() - t0
    dw = (DeepWalk.Builder().vectorSize(c["dw_d"])
          .windowSize(c["dw_window"]).learningRate(c["lr"])
          .negativeSample(c["negative"]).batchSize(c["batch"])
          .seed(c["seed"]).epochs(1).device(DEV).build())
    with _tapped(graph_dw, "_sgns_step") as tap:
        out = _nlp_fit("DeepWalk", dw,
                       lambda: dw.fit(g, walk_length=c["dw_walk"]),
                       ("_walk_pairs",), [tap])
    pairs = tap["calls"] * c["batch"]
    within, across = _topic_cosines(dw._syn0(), np.arange(g.numVertices()),
                                    block, c["sim_pairs"], c["seed"])
    log(f"[nlp] DeepWalk: {g.numVertices():,} vertices, {g.numEdges():,} "
        f"edges in {c['communities']} communities (made in {graph_s:.2f} "
        f"s), d = {c['dw_d']}, window {c['dw_window']}, walk length "
        f"{c['dw_walk']}, one walk per vertex, {pairs:,} pair slots "
        f"({pairs / out['loop_s']:,.0f} a second of the step loop): mean "
        f"cosine within a community {within:.4f}, across {across:.4f}")
    if not within > across:
        raise AssertionError(f"nlp: DeepWalk within {within} across "
                             f"{across}")
    out.update(vertices=g.numVertices(), edges=g.numEdges(), graph_s=graph_s,
               pairs=pairs, pairs_per_s=pairs / out["loop_s"],
               cos_within=within, cos_across=across,
               step_check=_nlp_step_check("DeepWalk", "sgns",
                                          graph_dw._sgns_step, tap))
    return out


def _kim_conf(c):
    b = (NeuralNetConfiguration.Builder().seed(c["seed"])
         .updater(Adam(1e-3)).graphBuilder().addInputs("words")
         .setInputTypes(InputType.recurrent(c["d"])))
    for k in c["kim_windows"]:
        b.addLayer(f"conv{k}", Convolution1DLayer(
            nOut=c["kim_maps"], kernelSize=k, convolutionMode="truncate",
            activation="relu"), "words")
        b.addLayer(f"pool{k}", GlobalPoolingLayer("max"), f"conv{k}")
    b.addVertex("merge", MergeVertex(),
                *[f"pool{k}" for k in c["kim_windows"]])
    b.addLayer("drop", DropoutLayer(0.5), "merge")
    b.addLayer("out", OutputLayer(lossFunction="mcxent", nOut=2,
                                  activation="softmax"), "drop")
    return b.setOutputs("out").build()


def _nlp_kim(vectors, words, topic, counts):
    """Kim's sentence CNN over the SGNS arm's vectors (B, T, 300)."""
    c = NLP
    rng = np.random.default_rng(c["seed"] + 4)
    sents, labels = [], []
    for _ in range(c["kim_sentences"]):
        t = int(rng.integers(c["topics"]))
        sents.append(" ".join(_topic_draws(words, topic, counts, t,
                                           c["kim_len"], rng)))
        labels.append("pos" if t < c["topics"] // 2 else "neg")
    it = (CnnSentenceDataSetIterator.Builder("RNN")
          .sentenceProvider(CollectionLabeledSentenceProvider(sents, labels))
          .wordVectors(vectors).minibatchSize(c["kim_batch"])
          .maxSentenceLength(c["kim_len"]).build())

    def batches():
        it.reset()
        t0 = time.perf_counter()
        out = []
        while it.hasNext():
            ds = it.next()
            ds.features = np.ascontiguousarray(ds.features.transpose(0, 2, 1))
            ds.featuresMask = None          # every sentence is full length
            out.append(ds)
        return out, time.perf_counter() - t0

    data, host_s = batches()
    net = ComputationGraph(_kim_conf(c)).init(DEV)
    held = data[0]
    score0 = float(net.score(held))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(c["kim_epochs"]):
        net.fit(ListDataSetIterator(data))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    score1 = float(net.score(held))
    params, state = graph_params_to_numpy(net)
    cpu = graph_params_from_numpy(ComputationGraph(_kim_conf(c)), params,
                                  state, device="cpu")
    x = held.features
    on_card = np.asarray(net.output(x))
    on_cpu = np.asarray(cpu.output(x))
    rel = float(np.abs(on_card - on_cpu).max() / np.abs(on_cpu).max())
    steps = c["kim_epochs"] * len(data)
    log(f"[nlp] Kim CNN: {len(sents):,} sentences of {c['kim_len']} tokens "
        f"through CnnSentenceDataSetIterator (RNN format, the SGNS vectors, "
        f"{host_s:.2f} s on the host), windows {list(c['kim_windows'])} x "
        f"{c['kim_maps']} maps, max over time, dropout 0.5, minibatch "
        f"{c['kim_batch']}: {c['kim_epochs']} epochs, {steps} steps in "
        f"{fit_s:.2f} s ({steps / fit_s:.1f} steps/s); the first batch's "
        f"score {score0:.4f} -> {score1:.4f}; output() card against the CPU "
        f"{rel:.3e} (rtol {NLP_CNN_RTOL:.0e})")
    if not (score1 < score0 and rel <= NLP_CNN_RTOL):
        raise AssertionError(f"nlp: Kim CNN score {score0} -> {score1}, "
                             f"card against the CPU {rel:.3e}")
    return {"host_s": host_s, "fit_s": fit_s, "steps": steps,
            "steps_per_s": steps / fit_s, "score_first": score0,
            "score_last": score1, "card_vs_cpu": rel}


def _nlp_serializer(model):
    """`model`'s vectors written and read back, binary then text. The
    phase passes the HS arm's (~10,000 words): the text format of the SGNS
    arm's 71,000 took ~30 s of the host's formatting and parsing, which
    the smoke's time limit cannot spare."""
    ref = model._table()
    out = {}
    NLP_DIR.mkdir(parents=True, exist_ok=True)
    for fmt in ("binary", "text"):
        path = NLP_DIR / f"vectors.{'bin' if fmt == 'binary' else 'txt'}"
        t0 = time.perf_counter()
        WordVectorSerializer.writeWord2VecModel(model, str(path),
                                                binary=fmt == "binary")
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = WordVectorSerializer.readWord2VecModel(str(path))
        read_s = time.perf_counter() - t0
        same_words = back.vocab.words() == model.vocab.words()
        err = float(np.abs(back._table() - ref).max())
        # the text format prints 6 decimals: each value within half a unit
        # of the 6th decimal (and the float32 rounding of the parse)
        ok = same_words and (err == 0.0 if fmt == "binary" else
                             err <= 5e-7 + 1e-7 * float(np.abs(ref).max()))
        size = path.stat().st_size
        log(f"[nlp] WordVectorSerializer {fmt}: {ref.shape[0]:,} x "
            f"{ref.shape[1]} in {size:,} bytes, written in {write_s:.2f} s, "
            f"read (format auto-detected) in {read_s:.2f} s; words equal "
            f"{same_words}, largest difference {err:.3e}")
        if not ok:
            raise AssertionError(f"nlp: {fmt} round trip: words "
                                 f"{same_words}, {err:.3e}")
        out[fmt] = {"bytes": size, "write_s": write_s, "read_s": read_s,
                    "max_abs_diff": err}
        path.unlink()
    return out


def _nlp_examples():
    out = {}
    for name in ("word2vec_text", "text_classification_tfidf",
                 "unsupervised_analysis"):
        mod = importlib.import_module(
            f"deeplearning4j_tpu_torch.examples.{name}")
        t0 = time.perf_counter()
        mod.main(device=DEV)
        torch.cuda.synchronize()
        out[name] = {"s": time.perf_counter() - t0}
        log(f"[nlp] example {name}: {out[name]['s']:.2f} s")
    return out


def phase_nlp():
    """Word, document, subword and graph embeddings at their published
    widths; none of the nine kernels runs on this path."""
    c = NLP
    _reset_counts()
    t0 = time.perf_counter()
    sents, words, topic, counts = nlp_corpus()
    topic_of = dict(zip(words, topic.tolist()))
    log(f"[nlp] corpus: {len(sents):,} sentences, "
        f"{int(counts.sum()):,} tokens, {len(words):,} types (each at least "
        f"{c['floor']} times) in {c['topics']} topics, made in "
        f"{time.perf_counter() - t0:.2f} s")
    out = {"corpus_tokens": int(counts.sum()), "types": len(words)}
    sgns_sents, _, _, sgns_counts = nlp_corpus(dict(c,
                                                    tokens=c["sgns_tokens"]))
    log(f"[nlp] SGNS corpus: {len(sgns_sents):,} sentences, "
        f"{int(sgns_counts.sum()):,} tokens of the same {len(words):,} types "
        f"and {c['topics']} topics")
    with _no_tf32():
        sgns, out["sgns"] = _nlp_word2vec(sgns_sents, topic_of, hs=False)
        del sgns_sents
        out["kim"] = _nlp_kim(sgns, words, topic, counts)
        del sgns
        hs, out["hs"] = _nlp_word2vec(sents, topic_of, hs=True)
        out["serializer"] = _nlp_serializer(hs)
        del hs
        out["fasttext"] = _nlp_fasttext(sents, words)
        gc.collect()
        torch.cuda.empty_cache()
        out["glove"] = _nlp_glove(sents)
        out.update(_nlp_paragraphs(words, topic, counts))
        out["deepwalk"] = _nlp_deepwalk()
        out["examples"] = _nlp_examples()
    out["launches"] = _counts()
    log(f"[nlp] launches of the nine kernels across the phase: "
        f"{out['launches']}")
    if any(out["launches"].values()):
        raise AssertionError(f"nlp: a kernel launched: {out['launches']}")
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -- phases 29 and 30: rl and examples -----------------------------------------
#: the rl phase (`--only rl`): rl4j's learners at the Atari widths. Arm A:
#: QLearningDiscreteConv with the JAX package's defaults (Mnih et al.
#: 2013's network: 16 filters 8×8/4, 32 filters 4×4/2, 256 dense units, lr
#: 2.5e-4; HistoryProcessorConfiguration(): 84×84, history 4, skip 4) on
#: PixelGridWorld(size=21, scale=8)'s 168×168 frames, batch 32, cut to
#: `max_step` agent steps and a replay of `replay` observations (~113 KB
#: each, stored twice a transition). Arm B: A3CDiscreteConv at the same
#: network and A3CConfiguration()'s defaults (8 envs, nstep 5),
#: `a3c_updates` updates. Arm C: A3CDiscreteDense and
#: AsyncNStepQLearningDiscreteDense on CartpoleNative at their defaults
#: (2×64, 8 envs), `dense_steps` env steps each.
RL = dict(max_step=1500, replay=10_000, batch=32, grid=21, scale=8,
          a3c_updates=100, dense_steps=2000, probe=256, probe_seed=5,
          check_seed=17)
#: one update on the card against the same update through the port on the
#: CPU, relative to the largest parameter: the conv learners (arms A, B)
#: and the dense ones (arm C); arm A also holds the Q-values, relative to
#: the largest, at RL_CONV_RTOL
RL_CONV_RTOL = 1e-5
RL_DENSE_RTOL = 1e-6
#: arm A's update itself (parameters after − before), card against CPU,
#: relative to its largest element: f32 parameters near 0.1 hold an
#: update of lr = 2.5e-4 to ~3e-5 of itself
RL_DELTA_RTOL = 1e-3


def _rl_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _rl_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _rl_leaves(v)]
    return [np.asarray(tree, np.float64)]


def _rl_rel(got, want):
    """max |got − want| over the leaves of two numpy trees, relative to the
    largest |want|."""
    g, w = _rl_leaves(got), _rl_leaves(want)
    assert len(g) == len(w)
    top = max(float(np.abs(x).max()) for x in w)
    return max(float(np.abs(a - b).max()) for a, b in zip(g, w)) / top


def _rl_equal(a, b):
    return all(np.array_equal(x, y) for x, y in zip(_rl_leaves(a),
                                                     _rl_leaves(b)))


def _rl_finite(tree):
    return all(np.isfinite(x).all() for x in _rl_leaves(tree))


def _rl_conv_learner(device):
    c = RL
    return rl.QLearningDiscreteConv(
        rl.PixelGridWorld(size=c["grid"], scale=c["scale"]),
        rl.DQNConvNetworkConfiguration(),
        rl.HistoryProcessorConfiguration(),
        rl.QLearningConfiguration(maxStep=c["max_step"],
                                  expRepMaxSize=c["replay"],
                                  batchSize=c["batch"]),
        device=device)


def _rl_td_error(net, target, batch, conf):
    """Mean |TD error| (unclamped) of `net` against `target` on a fixed
    batch: td_learn_batch's target without the fit."""
    obs, actions, rewards, next_obs, dones = batch
    q_next_t = np.asarray(target.output(next_obs))
    best = np.asarray(net.output(next_obs)).argmax(-1)
    boot = q_next_t[np.arange(len(best)), best]
    td = rewards * conf.rewardFactor + conf.gamma * boot * (1 - dones)
    q = np.asarray(net.output(obs))
    return float(np.abs(td - q[np.arange(len(actions)), actions]).mean())


def _rl_timed(learner, name, clock):
    """Wrap the learner's method `name` to add its wall seconds to
    clock[name]."""
    inner = getattr(learner, name)

    def call(*a):
        t0 = time.perf_counter()
        try:
            return inner(*a)
        finally:
            clock[name] += time.perf_counter() - t0

    setattr(learner, name, call)


def _rl_td_check(trained, probe_obs):
    """One td_learn_batch from the trained Q-network's weights, its Adam
    moments and step count, and its replay, on two card learners and a CPU
    one: the card repeats bit for bit; the online net's Q-values on the
    probe observations before the update, the parameters after it and
    the update itself (after − before) agree with the CPU within
    RL_CONV_RTOL, RL_CONV_RTOL and RL_DELTA_RTOL of their largest
    magnitude. The carried moments make the update's size follow the
    gradient's (a fresh Adam's first step is about lr·sign(g))."""
    from deeplearning4j_tpu_torch.rl.dqn import td_learn_batch
    from deeplearning4j_tpu_torch.util.model_serializer import _optax_leaves
    tree = rl.params_to_numpy(trained)
    moments = [t.detach().cpu() for t in _optax_leaves(trained.net)]
    q, out = [], []
    for dev in (DEV, DEV, "cpu"):
        lrn = _rl_conv_learner(dev)
        rl.params_from_numpy(lrn, tree)
        lrn.net._build_optimizer()
        leaves = _optax_leaves(lrn.net)
        assert len(leaves) == len(moments)
        with torch.no_grad():
            for dst, src in zip(leaves, moments):
                dst.copy_(src)
        q.append(np.asarray(lrn.net.output(probe_obs)))
        lrn.replay._buf = list(trained.replay._buf)
        lrn.replay._rng = np.random.default_rng(RL["check_seed"])
        td_learn_batch(lrn.net, lrn.target, lrn.replay, lrn.conf)
        out.append(rl.params_to_numpy(lrn)["net"][0])
        del lrn
    before = _rl_leaves(tree["net"][0])
    delta = [[a - b for a, b in zip(_rl_leaves(p), before)]
             for p in (out[0], out[2])]
    return {"td_repeat_equal": _rl_equal(out[0], out[1]),
            "td_card_vs_cpu": _rl_rel(out[0], out[2]),
            "td_delta_card_vs_cpu": _rl_rel(*delta),
            "q_card_vs_cpu": _rl_rel(q[0], q[2])}


def _rl_arm_a():
    c = RL
    learner = _rl_conv_learner(DEV)
    probe = {}
    first = learner._learn_batch

    def learn():
        if not probe:
            # a fixed probe batch from the replay (its own generator, so
            # the learner's draws are untouched), read before the first
            # update
            draw = rl.ExpReplay(c["replay"], c["probe"], c["probe_seed"])
            draw._buf = list(learner.replay._buf)
            probe["batch"] = draw.getBatch()
            probe["first"] = _rl_td_error(learner.net, learner.target,
                                          probe["batch"], learner.conf)
        first()

    learner._learn_batch = learn
    sync = learner.target.setParams

    def set_params(flat):
        if probe and "synced" not in probe:
            # the regression target of the first period: the probe against
            # the same frozen target net, just before it is replaced
            probe["synced"] = _rl_td_error(learner.net, learner.target,
                                           probe["batch"], learner.conf)
        return sync(flat)

    learner.target.setParams = set_params
    clock = {"_greedy_q": 0.0, "_learn_batch": 0.0, "getBatch": 0.0}
    _rl_timed(learner, "_greedy_q", clock)
    _rl_timed(learner, "_learn_batch", clock)
    _rl_timed(learner.replay, "getBatch", clock)
    base = 0
    if DEV == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # what earlier phases still hold is not the learner's
        base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    rewards = learner.train()
    if DEV == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    last = _rl_td_error(learner.net, learner.target, probe["batch"],
                        learner.conf)
    peak = (torch.cuda.max_memory_allocated() - base if DEV == "cuda"
            else None)
    check = _rl_td_check(learner, probe["batch"][0])
    # the network calls: the policy's B = 1 forwards and the TD updates
    # without their replay sampling (host numpy)
    net_s = clock["_greedy_q"] + clock["_learn_batch"] - clock["getBatch"]
    frames = learner.step_count * learner.hp.conf.skipFrame
    res = {"agent_steps": learner.step_count, "frames_max": frames,
           "episodes": len(rewards), "updates": learner.updates,
           "target_syncs": learner.target_syncs,
           "host_reads": learner.host_reads, "wall_s": wall,
           "steps_per_s": learner.step_count / wall,
           "updates_per_s": learner.updates / wall,
           "policy_forward_s": clock["_greedy_q"],
           "update_s": clock["_learn_batch"],
           "replay_sample_s": clock["getBatch"],
           "host_share": (wall - net_s) / wall, "peak_bytes": peak,
           "replay_len": len(learner.replay),
           "probe_td_first": probe["first"],
           "probe_td_first_sync": probe["synced"], "probe_td_last": last,
           **check, "last10_reward": float(np.mean(rewards[-10:]))}
    log(f"[rl] A: pixel DQN (84x84x4, 16/32/256) on PixelGridWorld("
        f"{c['grid']}, {c['scale']}): {learner.step_count} agent steps, "
        f"{learner.updates} updates of B={c['batch']} in {wall:.2f} s "
        f"({res['steps_per_s']:.1f} steps/s, {res['updates_per_s']:.1f} "
        f"updates/s), {len(rewards)} episodes; policy forwards "
        f"{clock['_greedy_q']:.2f} s, updates {clock['_learn_batch']:.2f} "
        f"s (replay sampling {clock['getBatch']:.2f} s of it), the host's "
        f"share outside the network calls {res['host_share']:.4f}; host "
        f"reads {learner.host_reads}; peak {peak} B above the {base} B "
        f"held before the run; probe |TD| "
        f"{probe['first']:.5f} at the first update -> "
        f"{probe['synced']:.5f} before the first target sync (the same "
        f"target) -> {last:.5f} after the last update; target syncs "
        f"{learner.target_syncs}; card vs CPU from the trained weights "
        f"and Adam moments: probe Q {check['q_card_vs_cpu']:.3e}, one "
        f"td_learn_batch's parameters {check['td_card_vs_cpu']:.3e} (rtol "
        f"{RL_CONV_RTOL:.0e} each), its update "
        f"{check['td_delta_card_vs_cpu']:.3e} (rtol {RL_DELTA_RTOL:.0e}), "
        f"repeat bit-identical {check['td_repeat_equal']}")
    want_syncs = c["max_step"] // learner.conf.targetDqnUpdateFreq
    if not (check["td_repeat_equal"]
            and check["q_card_vs_cpu"] <= RL_CONV_RTOL
            and check["td_card_vs_cpu"] <= RL_CONV_RTOL
            and check["td_delta_card_vs_cpu"] <= RL_DELTA_RTOL
            and probe["synced"] < probe["first"]
            and learner.target_syncs == want_syncs
            and _rl_finite(rl.params_to_numpy(learner))):
        raise AssertionError(f"rl: arm A: {res}")
    return res


def _rl_update_check(learner, make_cpu, rollout):
    """One `_update` from the learner's params and RMSprop state on the
    card, twice (bit-identical), and on a CPU twin carried across."""
    params, nu = rl.params_to_numpy(learner)
    outs = []
    for _ in range(2):
        p, s = learner._update(learner.params, learner.opt_state, *rollout)
        outs.append({g: [{k: v.cpu().numpy() for k, v in lyr.items()}
                         for lyr in layers] for g, layers in p.items()})
    cpu = rl.params_from_numpy(make_cpu(), params, nu=nu)
    p, _ = cpu._update(cpu.params, cpu.opt_state, *rollout)
    want = {g: [{k: v.numpy() for k, v in lyr.items()} for lyr in layers]
            for g, layers in p.items()}
    return _rl_equal(outs[0], outs[1]), _rl_rel(outs[0], want)


def _rl_a3c_run(name, make, rtol, check_v=False):
    learner = make(DEV)
    rollouts = []
    inner = learner._update

    def update(*a):
        rollouts[:] = [a[2:]]
        return inner(*a)

    learner._update = update
    v0 = copy.deepcopy(rl.params_to_numpy(learner)[0]["v"])
    t0 = time.perf_counter()
    learner.train()
    if DEV == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    learner._update = inner
    obs, actions, returns = rollouts[0]
    with torch.no_grad():
        loss = float(learner._loss(
            learner.params, learner._tensor(obs),
            learner._tensor(actions, torch.int64), learner._tensor(returns)))
    repeat_equal, cpu_rel = _rl_update_check(
        learner, lambda: make("cpu"), rollouts[0])
    params = rl.params_to_numpy(learner)[0]
    v_same = _rl_equal(v0, params["v"])
    res = {"env_steps": learner.step_count, "updates": learner.updates,
           "wall_s": wall, "env_steps_per_s": learner.step_count / wall,
           "updates_per_s": learner.updates / wall,
           "episodes": len(learner.episode_rewards),
           "host_reads": learner.host_reads, "loss": loss,
           "update_card_vs_cpu": cpu_rel, "update_repeat_equal":
           repeat_equal, "v_unchanged": v_same}
    log(f"[rl] {name}: {learner.step_count} env steps, {learner.updates} "
        f"updates of {len(obs)} rows in {wall:.2f} s "
        f"({res['env_steps_per_s']:.1f} env steps/s, "
        f"{res['updates_per_s']:.1f} updates/s), "
        f"{res['episodes']} episodes, loss on the last rollout {loss:.5f}; "
        f"one update card vs CPU {cpu_rel:.3e} (rtol {rtol:.0e}), repeat "
        f"bit-identical {repeat_equal}"
        + (f"; the v head unchanged {v_same}" if check_v else ""))
    if not (repeat_equal and cpu_rel <= rtol and np.isfinite(loss)
            and _rl_finite(params) and (v_same or not check_v)):
        raise AssertionError(f"rl: {name}: {res}")
    return res


def phase_rl():
    """Arms A–C at rl4j's Atari widths; none of the nine kernels runs on
    this path (counted, checked zero)."""
    c = RL
    _reset_counts()
    out = {}
    with _no_tf32(), _deterministic():
        out["dqn_conv"] = _rl_arm_a()
        gc.collect()
        a3c = rl.A3CConfiguration()
        conv_steps = c["a3c_updates"] * a3c.numEnvs * a3c.nstep

        def conv(dev):
            return rl.A3CDiscreteConv(
                lambda: rl.PixelGridWorld(size=c["grid"], scale=c["scale"]),
                rl.A3CConfiguration(maxStep=conv_steps), device=dev)

        out["a3c_conv"] = _rl_a3c_run("B: A3CDiscreteConv (84x84x4, "
                                      "16/32/256, 8 envs, nstep 5)", conv,
                                      RL_CONV_RTOL)

        def dense(dev):
            return rl.A3CDiscreteDense(
                lambda: rl.CartpoleNative(seed=0),
                rl.A3CConfiguration(maxStep=c["dense_steps"]), device=dev)

        def nstep(dev):
            return rl.AsyncNStepQLearningDiscreteDense(
                lambda: rl.CartpoleNative(seed=0),
                rl.A3CConfiguration(maxStep=c["dense_steps"]), device=dev)

        out["a3c_dense"] = _rl_a3c_run("C: A3CDiscreteDense (2x64, 8 envs) "
                                       "on CartpoleNative", dense,
                                       RL_DENSE_RTOL)
        out["nstep_q"] = _rl_a3c_run("C: AsyncNStepQLearningDiscreteDense "
                                     "(2x64, 8 envs) on CartpoleNative",
                                     nstep, RL_DENSE_RTOL, check_v=True)
    out["launches"] = _counts()
    log(f"[rl] launches of the nine kernels across the phase: "
        f"{out['launches']}")
    if any(out["launches"].values()):
        raise AssertionError(f"rl: a kernel launched: {out['launches']}")
    gc.collect()
    if DEV == "cuda":
        torch.cuda.empty_cache()
    return out


#: the examples phase (`--only examples`): the 15 twins of examples/ this
#: slice adds, each at its script's settings; the attention classifier and
#: the long-context recipe run the flash kernels (B1, B2a, B2b), the
#: others none of the nine
EXAMPLE_TWINS = ("dqn_cartpole", "pixel_dqn_gridworld", "mnist_cnn",
                 "transfer_learning", "vae_anomaly", "custom_layer",
                 "mixture_density_regression", "char_rnn_generation",
                 "attention_sequence_classifier", "object_detection_yolo",
                 "samediff_graph", "model_artifacts",
                 "hyperparameter_search", "distributed_data_parallel",
                 "long_context_bert")
EXAMPLE_FLASH = ("attention_sequence_classifier", "long_context_bert")
#: a twin's arguments where its depth is cut: dqn_cartpole's host-bound
#: loop (a B = 1 forward an agent step) at 4,000 of the script's 12,000
#: steps; the rl phase runs DQN at the Atari widths
EXAMPLE_KW = {"dqn_cartpole": {"maxStep": 4000}}


def _example_numbers(x):
    """Every float in the returned facts (nested)."""
    if isinstance(x, dict):
        return [v for k in x for v in _example_numbers(x[k])]
    if isinstance(x, (list, tuple)):
        return [v for e in x for v in _example_numbers(e)]
    if isinstance(x, (float, np.floating)):
        return [float(x)]
    return []


def phase_examples():
    """Each twin's `main(device=DEV)` with the launch counts set to 0
    just before it and read just after; its script's checks raise inside
    it; every number it returns (every loss it prints) must be finite."""
    import io
    out = {}
    for name in EXAMPLE_TWINS:
        mod = importlib.import_module(
            f"deeplearning4j_tpu_torch.examples.{name}")
        printed = io.StringIO()
        _reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            facts = mod.main(device=DEV, **EXAMPLE_KW.get(name, {}))
            if name == "hyperparameter_search":
                facts = {"main": facts,
                         "declarative": mod.main_declarative(device=DEV)}
        if DEV == "cuda":
            torch.cuda.synchronize()
        s = time.perf_counter() - t0
        counts = _counts()
        text = printed.getvalue()
        nums = _example_numbers(facts)
        finite = all(np.isfinite(nums)) and not re.search(
            r"\b(nan|inf)\b", text, re.IGNORECASE)
        flash = {k: counts[k] for k in PAR_BERT_KERNELS}
        others = {k: v for k, v in counts.items() if k not in flash}
        launched_ok = (not any(others.values())) and (
            (all(flash.values()) or DEV != "cuda") if name in EXAMPLE_FLASH
            else not any(flash.values()))
        out[name] = {"s": s, "facts": facts, "launches": counts}
        last = [ln for ln in text.strip().splitlines() if ln][-1:]
        log(f"[examples] {name}: {s:.2f} s; "
            f"{last[0][:140] if last else ''}"
            + (f"; flash launches {flash}" if name in EXAMPLE_FLASH else ""))
        if not (finite and launched_ok):
            raise AssertionError(f"examples: {name}: finite {finite}, "
                                 f"launches {counts}\n{text}")
    out["launches"] = {k: sum(out[n]["launches"][k] for n in EXAMPLE_TWINS)
                       for k in out[EXAMPLE_TWINS[0]]["launches"]}
    gc.collect()
    if DEV == "cuda":
        torch.cuda.empty_cache()
    return out


# -- main ---------------------------------------------------------------------
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only",
                    choices=["kernels", "resnet", "graphs", "paged",
                             "chaos", "fleet", "mln", "rnn", "heads", "zoo",
                             "layers", "resilience", "quant", "parallel",
                             "multihost", "keras", "samediff", "onnx",
                             "spark", "arbiter", "clustering", "nlp", "rl",
                             "examples"],
                    default=None,
                    help="stop after the kernel checks, or run the resnet "
                         "serving and training phases right after them, or "
                         "run the graphs, the paged, the chaos, the fleet, "
                         "the mln, the rnn, the heads, the zoo, the "
                         "layers, the "
                         "resilience, the quant, the parallel, the "
                         "multihost, the keras, the samediff, the onnx, the "
                         "spark, the arbiter, the clustering, the nlp, the "
                         "rl or the examples phase alone "
                         "after the build (bring-up runs; arbiter makes the "
                         "spark phase's batches first)")
    ap.add_argument("--profile", action="store_true",
                    help="after the resnet phases, profile the serving "
                         "workload, three fine-tune steps, one ResNet-50 "
                         "forward and one ResNet-50 training step (card "
                         "busy/idle share, device time by kernel group); "
                         "with the mln phase, VGG16's step and forward; "
                         "with the rnn phase, the TBPTT batch and the "
                         "LSTM server; with the layers phase, CapsNet's "
                         "steps; with the quant phase, the int8 and fp "
                         "ResNet-50 forwards")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    seconds = {}
    global _TIMELINE
    OUT_DIR.mkdir(exist_ok=True)
    name = f"smoke_timeline_{args.only}.log" if args.only else \
        "smoke_timeline.log"
    _TIMELINE = (OUT_DIR / name, t0)
    _TIMELINE[0].write_text("")

    def timed(phase, fn, *a):
        _mark(f"[smoke] {phase} starts")
        t = time.perf_counter()
        out = fn(*a)
        seconds[phase] = time.perf_counter() - t
        _mark(f"[smoke] {phase} took {seconds[phase]:.1f} s")
        return out

    def side_by_side(*phases):
        """Run phases whose work is all in rank processes they spawn (they
        share no file, store or port) at once, each from its own thread;
        the first failure is raised after all have ended."""
        results, errors = {}, []

        def run(name, fn):
            try:
                results[name] = timed(name, fn)
            except BaseException as e:   # raised below, after the join
                errors.append(e)

        threads = [threading.Thread(target=run, args=p, name=p[0])
                   for p in phases]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return tuple(results[name] for name, _ in phases)

    card = timed("card", phase_card)
    build_s = timed("build", phase_build)
    OUT_DIR.mkdir(exist_ok=True)
    if args.only in ("graphs", "paged"):
        cfg = bert_base()
        phase = phase_graphs if args.only == "graphs" else phase_paged
        out = timed(args.only, phase, cfg, init_bert_params(cfg, 0))
        (OUT_DIR / f"smoke_{args.only}.json").write_text(json.dumps(
            {"card": card, args.only: out, "phase_seconds": seconds},
            indent=1))
        log(f"[smoke] by phase " + ", ".join(
            f"{k} {v:.1f}" for k, v in seconds.items()))
        return 0
    if args.only in ("chaos", "fleet", "mln", "rnn", "heads", "zoo",
                     "layers",
                     "resilience", "quant", "parallel", "multihost",
                     "keras", "samediff", "onnx", "spark", "arbiter",
                     "clustering", "nlp", "rl", "examples"):
        if args.only in ("keras", "samediff"):
            cfg = bert_base()
            phase = phase_keras if args.only == "keras" else phase_samediff
            out = timed(args.only, phase, cfg, init_bert_params(cfg, 0))
        elif args.only == "parallel":
            out = timed("parallel", phase_parallel)
        elif args.only == "multihost":
            out = timed("multihost", phase_multihost)
        elif args.only == "mln":
            out = timed("mln", phase_mln, args.profile)
        elif args.only == "rnn":
            out = timed("rnn", phase_rnn, args.profile)
        elif args.only == "heads":
            out = timed("heads", phase_heads)
        elif args.only == "zoo":
            out = timed("zoo", phase_zoo)
        elif args.only == "layers":
            out = timed("layers", phase_layers, args.profile)
        elif args.only == "resilience":
            out = timed("resilience", phase_resilience)
        elif args.only == "quant":
            out = timed("quant", phase_quant, args.profile)
        elif args.only == "onnx":
            out = timed("onnx", phase_onnx)
        elif args.only == "spark":
            out = timed("spark", phase_spark)[0]
        elif args.only == "arbiter":
            out = timed("arbiter", phase_arbiter)
        elif args.only == "clustering":
            out = timed("clustering", phase_clustering)
        elif args.only == "nlp":
            out = timed("nlp", phase_nlp)
        elif args.only == "rl":
            out = timed("rl", phase_rl)
        elif args.only == "examples":
            out = timed("examples", phase_examples)
        else:
            cfg = bert_base()
            phase = phase_chaos if args.only == "chaos" else phase_fleet
            out = timed(args.only, phase, cfg, init_bert_params(cfg, 0))
        (OUT_DIR / f"smoke_{args.only}.json").write_text(json.dumps(
            {"card": card, args.only: out, "phase_seconds": seconds},
            indent=1, default=str))
        log(f"[smoke] by phase " + ", ".join(
            f"{k} {v:.1f}" for k, v in seconds.items()))
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    rows, kernel_launches = timed("kernels", phase_kernels)
    step36 = step36_summary(rows)
    fwd36 = fwd36_summary(rows)
    step12 = bert_step12_summary(rows)
    if args.only == "kernels":
        (OUT_DIR / "smoke_kernels.json").write_text(json.dumps(
            {"card": card, "kernels": rows, "step36": step36,
             "fwd36": fwd36, "bert_step12": step12}, indent=1))
        return 0
    if args.only == "resnet":
        resnet, _, _ = timed("resnet", phase_resnet)
        resnet_train, _, _ = timed("resnet_train", phase_resnet_train)
        (OUT_DIR / "smoke_resnet.json").write_text(json.dumps(
            {"card": card, "kernels": rows, "step36": step36,
             "fwd36": fwd36, "bert_step12": step12,
             "resnet": resnet, "resnet_train": resnet_train,
             "phase_seconds": seconds}, indent=1))
        return 0
    cfg = bert_base()
    params = timed("params", init_bert_params, cfg, 0)
    encoder = timed("encoder", phase_encoder, cfg, params)
    serving = timed("serving", phase_serving, cfg, params)
    train = timed("train", phase_train, cfg, params)
    resnet, resnet_net, resnet_x = timed("resnet", phase_resnet)
    resnet_train, train_net, train_ds = timed("resnet_train",
                                              phase_resnet_train)
    graphs = timed("graphs", phase_graphs, cfg, params)
    paged = timed("paged", phase_paged, cfg, params)
    chaos = timed("chaos", phase_chaos, cfg, params)
    fleet = timed("fleet", phase_fleet, cfg, params)
    mln = timed("mln", phase_mln, args.profile)
    rnn = timed("rnn", phase_rnn, args.profile)
    heads = timed("heads", phase_heads)
    zoo = timed("zoo", phase_zoo)
    layers = timed("layers", phase_layers, args.profile)
    resilience = timed("resilience", phase_resilience)
    quant = timed("quant", phase_quant, args.profile)
    parallel, multihost = side_by_side(("parallel", phase_parallel),
                                       ("multihost", phase_multihost))
    keras = timed("keras", phase_keras, cfg, params)
    samediff = timed("samediff", phase_samediff, cfg, params)
    onnx = timed("onnx", phase_onnx)
    spark, spark_batches = timed("spark", phase_spark)
    arbiter = timed("arbiter", phase_arbiter, spark_batches)
    del spark_batches
    clustering = timed("clustering", phase_clustering)
    nlp = timed("nlp", phase_nlp)
    rl_res = timed("rl", phase_rl)
    examples = timed("examples", phase_examples)
    prof = (timed("profile", phase_profile, cfg, params, resnet_net,
                  resnet_x, train_net, train_ds) if args.profile else None)
    # each kernel's launches from the path that carries it: the forward and
    # decode kernels from serving, the backward pair from training, the
    # epilogue GEMM from ResNet serving, the int8 epilogue from the int8
    # ResNet-50's serving; the bottleneck block and the layer norm are
    # entry points no model calls, so theirs come from the res4 check and
    # from the kernel phase
    launches = {k: serving["launches"][k]
                for k in ("flash_fwd", "flash_decode")}
    launches.update({k: train["launches"][k]
                     for k in ("flash_bwd_dq", "flash_bwd_dkv")})
    launches["matmul_epilogue"] = resnet["launches"]["matmul_epilogue"]
    launches["int8_matmul_epilogue"] = \
        quant["launches"]["int8_matmul_epilogue"]
    launches["bottleneck_block"] = resnet["res4_block"]["launches"]
    launches.update({k: resnet_train["launches"][k] for k in TRAIN_KERNELS})
    launches["fused_layernorm"] = kernel_launches["fused_layernorm"]
    launches_from = {"flash_fwd": "bert serving", "flash_decode":
                     "bert serving", "flash_bwd_dq": "bert training (10 "
                     "timed steps)", "flash_bwd_dkv": "bert training (10 "
                     "timed steps)", "matmul_epilogue": "resnet serving "
                     f"({resnet['forwards']} forwards)",
                     "int8_matmul_epilogue": "int8 ResNet-50 serving "
                     f"({quant['serving']['forwards']} forwards, 37 "
                     "quantized layers each)",
                     "bottleneck_block": "resnet res4_1 check (no served "
                     "model calls it)",
                     "fused_layernorm": "kernel phase (checks and timing; "
                     "no model calls it)"}
    launches_from.update({k: f"resnet training ({RESNET_TRAIN['steps']} "
                          "timed steps)" for k in TRAIN_KERNELS})
    line = kernel_line(rows, launches, launches_from)
    for row in line["kernels"]:
        if row["name"] in rnn["launches"]:
            # the attention stack's graphed training
            row["launches_attention"] = rnn["launches"][row["name"]]
        if row["name"] in zoo["launches"]:
            # this slice's path: InceptionResNetV1's fused graphed steps
            # (the epilogue: one fused output())
            row["launches_zoo"] = zoo["launches"][row["name"]]
            row["launches_zoo_from"] = (
                "InceptionResNetV1 one B=32 output()"
                if row["name"] == "matmul_epilogue" else
                f"InceptionResNetV1 fused graph arm ({ZOO['steps']} timed "
                "steps)")
        if row["name"] in layers["launches"]:
            # this slice's path: the restored InceptionResNetV1's resumed
            # graphed steps (the epilogue: its first output())
            row["launches_layers"] = layers["launches"][row["name"]]
            row["launches_layers_from"] = (
                "restored InceptionResNetV1 one B=32 output()"
                if row["name"] == "matmul_epilogue" else
                f"restored InceptionResNetV1 ({LAYERS['resume_steps']} "
                "resumed graphed steps)")
        if row["name"] in resilience["launches"]:
            # this slice's path: the guarded graphed ResNet-50 steps (the
            # epilogue: one output() of the guarded net)
            row["launches_resilience"] = resilience["launches"][row["name"]]
            row["launches_resilience_from"] = (
                "guarded ResNet-50 one B=32 output()"
                if row["name"] == "matmul_epilogue" else
                f"guarded ResNet-50 fused graph arm ({RESIL['steps']} timed "
                "steps)")
        if row["name"] in TRAIN_KERNELS:
            # this slice's path: the fine-tune's graphed steps under early
            # stopping (7 unfrozen pairs)
            row["launches_quant"] = quant["launches"][row["name"]]
            row["launches_quant_from"] = (
                f"ResNet-50 fine-tune ({quant['finetune']['iterations']} "
                "graphed steps)")
    for row in line["kernels"]:
        # this slice's paths: every rank's flash-ring BERT steps and
        # ParallelWrapper ResNet-50 steps, both arms of the parallel phase
        row["launches_parallel"] = parallel["launches"][row["name"]]
        row["launches_parallel_from"] = (
            f"parallel phase: {PAR['steps']} ring-trainer steps and "
            f"{PAR['resnet_steps'] + PAR['resnet_timed']} (arm A) / "
            f"{PAR['resnet_steps']} (arm B) wrapper steps on every rank")
        # this slice's path: arm A's MultiHostRunner steps (BERT-base,
        # accumulation 2)
        row["launches_multihost"] = multihost["launches"][row["name"]]
        row["launches_multihost_from"] = (
            f"multihost phase arm A: {MH['steps']} optimizer steps of "
            f"{MH['accum']} microbatches through MultiHostRunner")
        # this slice's paths: Keras MobileNetV2's profiled graphed steps
        # (B5, B7, B8; B6: its one bucket-graph forward) and the profiled
        # BERT-base fine-tune steps (B1, B2a, B2b)
        name = row["name"]
        if name in TRAIN_KERNELS:
            row["launches_keras"] = keras["launches"][name]
            row["launches_keras_from"] = (
                f"Keras MobileNetV2 ({KERAS['steps']} profiled graphed "
                f"steps, {KERAS['pairs']} pairs)")
        elif name == "matmul_epilogue":
            row["launches_keras"] = keras["serve"]["launches"]
            row["launches_keras_from"] = "Keras MobileNetV2 one B=32 forward"
        elif name in keras["launches_bert"]:
            row["launches_keras"] = keras["launches_bert"][name]
            row["launches_keras_from"] = (
                f"BERT-base ({KERAS['bert_steps']} profiled fine-tune "
                "steps)")
        # this slice's paths: the fused forward the ONNX import is held
        # to (B6), Spark's profiled epoch and arbiter's replayed candidate
        # steps (B5, B7, B8)
        if name == "matmul_epilogue":
            row["launches_onnx"] = onnx["launches"][name]
            row["launches_onnx_from"] = ("fused ResNet-50 one B=32 output() "
                                         "(the ONNX import's reference)")
        if name in TRAIN_KERNELS:
            row["launches_spark"] = spark["launches"][name]
            row["launches_spark_from"] = (
                f"SparkComputationGraph epoch 2 ({spark['batches']} graphed "
                "steps)")
            row["launches_arbiter"] = arbiter["launches"][name]
            row["launches_arbiter_from"] = (
                f"arbiter: {ARBITER['resnet_candidates']} ResNet-50 "
                f"candidates x {ARBITER['steps'] - 2} replayed steps")
        # this slice's path: the 15 example twins of the examples phase
        # (the flash kernels from the attention classifier's 30 graphed
        # steps and the long-context recipe's 3 ring steps; the rl phase
        # launches none of the nine)
        row["launches_examples"] = examples["launches"][name]
        row["launches_examples_from"] = (
            "examples phase: attention_sequence_classifier + "
            "long_context_bert (the other 13 twins launch none)")
        # this slice's path: the one-head stack's graphed steps at D = 256
        # (B1, B2a, B2b) and the served decoders at D = 256 and D = 8 (B1's
        # prefill and decode), and the kernel rows at its head dims
        if name in heads["train"]["launches"]:
            row["launches_heads"] = heads["train"]["launches"][name]
            row["launches_heads_from"] = (
                f"heads phase: one-head stack at D = {HEADS['width']}, "
                f"{HEADS['steps']} timed graphed steps")
        if name in heads["serving_launches"]:
            row["launches_heads_serving"] = heads["serving_launches"][name]
            row["launches_heads_serving_from"] = (
                "heads phase: BertDecoder servers at D = 256 (3 heads) and "
                "D = 8 (dense and paged), 12 requests each")
        row["head_dims"] = [
            {k: r[k] for k in ("case", "shape", "dtype", "ms", "plain_ms",
                               "library_ms", "bound_ms", "bound_by",
                               "max_abs_err", "atol")}
            for r in rows if r["name"] == name and r["case"] in HEAD_DIM_CASES]
    (OUT_DIR / "smoke.json").write_text(json.dumps(
        {"card": card, "build_s": build_s, "kernels": rows,
         "step36": step36, "fwd36": fwd36, "bert_step12": step12,
         "encoder": encoder,
         "serving": serving, "train": train,
         "resnet": resnet, "resnet_train": resnet_train, "graphs": graphs,
         "paged": paged, "chaos": chaos, "fleet": fleet, "mln": mln,
         "rnn": rnn, "heads": heads, "zoo": zoo, "layers": layers,
         "resilience": resilience, "quant": quant, "parallel": parallel,
         "multihost": multihost, "keras": keras, "samediff": samediff,
         "onnx": onnx, "spark": spark, "arbiter": arbiter,
         "clustering": clustering, "nlp": nlp, "rl": rl_res,
         "examples": examples, "profile": prof,
         "line": line,
         "phase_seconds": seconds, "seconds": time.perf_counter() - t0},
        indent=1, default=str))
    log(f"[smoke] {time.perf_counter() - t0:.1f} s; by phase "
        + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    print(card, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
