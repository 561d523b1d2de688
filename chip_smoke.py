#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``visitron_torch``) on one card.

    python3 chip_smoke.py                  # on a machine with an H100
    python3 chip_smoke.py --cpu-rehearsal  # tiny sizes, plain twins, on the CPU

Phases, one or more lines each; any failure raises and exits non-zero:

  1. device   the card's name, count, and nvidia-smi's name and power limit
              (no CUDA device: the script fails);
  2. build    nvcc builds the kernels for sm_90a from visitron_torch/csrc
              (ptxas register/spill lines and performance warnings, build
              seconds);
  3. K1       packed fused attention vs its plain twin at the serving shapes
              (B 64, S 256 and 512, 12 heads of 64, bf16 with padding), in
              fp32, and with hash dropout at rate 0.1; times of the kernel,
              the twin, torch's scaled_dot_product_attention as a yardstick
              (never called by the port), and the bound, then the device
              time of the kernel and of the yardstick from torch.profiler;
  4. K2       fused add+LayerNorm vs its plain twin (R = 16*768, 64*256 and
              64*512, H 768, bf16 and fp32, with and without a residual);
              times and F.layer_norm as the yardstick, then the device time
              of the kernel and of the yardstick from torch.profiler;
  5. K1b      the attention backward vs its plain twin at the train shapes
              (B 64, S 256 and 512, 12 heads of 64, bf16 with padded keys,
              fp32, and hash dropout at rate 0.1, whose masks are K1f's), and
              two bf16 launches on the same inputs equal bit for bit; times
              of the kernel, the twin, the autograd backward of torch's
              scaled_dot_product_attention as a yardstick, and the bound,
              then the device time of the kernel (by kernel: dq, dk/dv) and
              of the yardstick from torch.profiler, which leaves out the
              host's time to issue a call;
  6. K2b      the add+LayerNorm backward vs its twin (R = 16*768, 64*256 and
              64*512, H 768, bf16 and fp32, with and without a residual; dh,
              dgamma, dbeta), and two bf16 launches on the same inputs equal
              bit for bit; times and the autograd backward of
              F.layer_norm(x + res) as the yardstick, then the device time of
              the kernel (by kernel: the row kernel, the final sum) and of the
              yardstick from torch.profiler;
  7. K3       the fused masked softmax-CE, forward and backward, vs its twins
              at the MLM head's shape (R = 16*768, V = 30525, bf16 and fp32,
              ~10% ignored rows and labels outside [0, V)); times of the
              kernels, the twins, F.cross_entropy and its autograd backward,
              and the bounds;
  8. K4       the fused attention on (B, H, S, D) views of a packed QKV
              projection, forward and backward, vs its twins at the
              pretraining shape (B 16, S 768, 12 heads of 64, padded keys,
              bf16 and fp32, rates 0 and 0.1; bf16 also in 6 heads of 128),
              K4 against K1 on the same data (equal bit for bit), and two
              bf16 backward launches equal bit for bit; times with SDPA as
              the yardstick, K4f also in the S 768 step's call (rate 0.1,
              lse), and the device times of the forward (as in phase 3) and
              of the backward (as in phase 5);
  9. K5       the flash attention, forward (with its lse) and backward, vs its
              twins on (B, H, S, D) views of packed projections: at the
              long-context shape (B 16, S 1024, 12 heads of 64, the last 8 of
              512 region slots masked, bf16 and fp32, rates 0 and 0.1; bf16
              at rate 0.1 also in 6 heads of 128), at B 2 x S 4096 (bf16,
              rate 0.1: no length ceiling) and Q 512 x K 1024; two backward
              launches equal bit for bit; K5f against K4f on the same data at
              S 768; times of the kernels (K5b also at rate 0, like for like
              with the SDPA backward), the twins, SDPA forward and backward
              as the yardstick, and the bounds; the forward's device times
              (the eval call against SDPA, and the train call), the
              backward's (di, dq, dk/dv) as in phase 5, at rates 0.1 and 0;
 10. serving  the NDH argmax serving rollout, ViewpointAgent.test, at BERT-base
              width and depth (bf16, batch 64, 10-step episodes, 2048-d
              features, rnn 512, random weights from a seed), with and without
              ``submit``; trajectories checked against the graph; kernel
              launch counts read around each run; fp32 agreement of the card
              with the CPU on a 2-item batch; ms per batch, episodes/s,
              actions/s, the time split (BERT / LSTM / decode loop), peak memory;
 11. train    the NDH teacher-forced train step, ViewpointAgent.train_step_fn
              over NavEpisodeBatcher.train_batches (planner_path, batch 64,
              10-step episodes, the agent's dropouts, Adam at 5e-5, clip 40):
              2 warm-up steps and 5 timed; losses finite, params changed,
              the launches of every kernel counted around one step and the
              timed run; ms per step, nav actions/s, the forward / backward /
              optimizer split, peak memory; tools/torch_profile_nav_step.py's
              summary (visitron_torch.testing.nav_profile) of 3 steps under
              torch.profiler: busy time, idle share, device time by kind of
              kernel and the top kernels, gated on the device kernels a step
              other than host-to-device copies (14840; the copies vary, 4-7
              a step) and on K1f / K1b / K2f / K2b in the trace at the
              counted launches; then one fp32 step with every dropout at 0 on a
              2-item batch on the card and on the CPU: loss, gradients and
              updated parameters agree;
 12. pretrain the multimodal pretraining step, PretrainTrainer.step_fn, at
              tools/bench_pretrain.py's configuration (BERT-base bf16, vocab
              30525, batch 16 x (512 text + 256 regions), MLM + next-action +
              region-token labels, AdamW 5e-5, clip 1.0, the training
              dropouts): 2 warm-up steps and 5 timed; losses finite, every
              parameter changed, launches per step K3f 1, K3b 1, K4f 12, K4b
              12, K2f 26, K2b 26 and no K1 or K5; ms per step, examples/s, MFU
              from analytic FLOPs, peak memory, the idle share and device
              time by kind of kernel;
 13. pretrain agreement: two fp32 steps with every dropout at 0 on 2 items at
              S 640 (K4 and K3 run) on the card and on the CPU: losses, every
              gradient, and the AdamW update after two steps in units of lr;
 14. long-context pretrain: the same step with ``use_flash_attention`` at
              batch 16 x (512 text + 512 region slots, the last 8 masked, as
              a PretrainDataset(regions_per_view=14, max_img_seq_length=512)
              batch has them) = S 1024, which the fused gate refuses: launches
              per step K5f 12, K5b 12, K3f 1, K3b 1, K2f 26, K2b 26 and no K1
              or K4, with the same readings as phase 12; one eval_fn batch
              (K5f 12, K5b 0, no lse written); one forward and backward with
              ``remat`` from the same parameters, batch and DropoutRng seeds
              as one without: the loss equal, gradients within GRAD_TOL, the
              peak memory of both;
 15. long-context agreement: two fp32 steps with every dropout at 0 on 2
              items at S 896 (512 text + 384 regions, the shortest length the
              fused gate refuses, so the dispatch picks K5) on the card and
              on the CPU, as in phase 13 (K5f runs, K5b not: at rate 0 the
              backward recomputes through the plain attention); then one
              step with attention dropout 0.1 and hidden dropouts 0, whose
              kernel seeds come from one CPU generator on both sides, so K5b
              runs on the card against its twin on the CPU: loss and
              gradients agree;
 16. sampled train: the NDH student-forced train step,
              ViewpointAgent.sample_train_step_fn("sample"), at phase 11's
              set-up over NavEpisodeBatcher.with_sample_teacher batches: 2
              warm-up steps and 5 timed, launches per step K1f 12, K1b 12,
              K2f 25, K2b 25, losses finite, params changed, ms per step,
              nav actions/s, peak memory, the idle share; then one step each
              with argmax, topk, nucleus, temperature and penalty feedback;
 17. RL train: the same for rl_train_step_fn (A2C with the critic), its aux
              values finite;
 18. no host sync: the decode halves of a sampled step (every strategy) and
              of an RL step, with the batch on the card, under
              torch.cuda.set_sync_debug_mode("error");
 19. student agreement: fp32 with every dropout at 0 on a 2-item batch, card
              vs CPU: the sampled loss and gradients with argmax feedback,
              the RL loss, aux values and gradients (critic included) under
              one stand-in sampler (argmax of the logits plus a fixed noise
              table);
 20. sampling: select_action's slot frequencies on the card for sample,
              temperature, penalty, topk and nucleus over 65536 draws against
              each one's distribution (5 sigma a slot), argmax equal to the
              CPU's;
 21. evaluate: phase 10's argmax trajectories scored by the port's
              Evaluator (the summary printed);
 22. cli:     ``python -m visitron_torch.run`` through ``run.main`` on the
              --debug world, BERT-base from ``Workspace._bert_config``, bf16,
              scale-only overrides (iterations, epochs, logging and saving
              steps, eval_iters, output_dir in a temporary directory):
              ``viewpoint`` with viewpoint_train/ndh_oscar_setting.json
              (batch 4, sample feedback, 40-step episodes) 4 iterations,
              then ``--resume`` to 6 (checkpoints 4 and 6, the Adam count;
              iteration 6 under ``--profile_steps 1``: its trace's device
              busy time and idle share),
              val of checkpoint 6 (the Evaluator summary) and
              ``--test_only`` (the submission); checkpoint-6 saved again
              synchronously and asynchronously (ms of the call and until
              durable, size); ``pretrain`` with
              pretrain/pretrain_ndh_r2r.json for one epoch (its checkpoint,
              the per-dataset val sweeps); ablation 3's fine-tune
              (ablations/3_only_oscar_mlm-finetune_ndh.json) from that
              pretraining output for 2 iterations, at the pretraining
              run's max_seq_length 512, whose position table the graft's
              shape rule needs.  Every iteration logs, so each ends in its
              one read-back: the host clock between boundaries gives ms per
              iteration, the launch counts between them each iteration's
              launches (fine-tuning K1f 12, K1b 12, K2f 25, K2b 25;
              pretraining at S 704, which the fused gate refuses, K3f 1,
              K3b 1, K2f 26, K2b 26 and no K4); peak memory;
 23. turn_based: ``run turn_based`` with
              turn_based_train/ndh_oscar_setting.json (batch 4, player path:
              40-step episodes, teacher forcing) 4 iterations, --resume to 6
              (checkpoints 4 and 6, the Adam count), val of checkpoint 6;
              ms per iteration beside phase 22's viewpoint iteration;
              launches per iteration K1f 12, K1b 12, K2f 25, K2b 25; one
              argmax rollout batch from checkpoint 6 (K1f 12, K2f 25; the
              (B,) action read-backs and the synchronising calls a step,
              under torch.cuda.set_sync_debug_mode("warn")); before the CLI
              phases, one fp32 turn-based step on a 2-item batch, card vs
              CPU, as phase 11's agreement;
 24. classifier: ``run classifier`` with classifier/classifier.json (batch
              1, 40-step episodes, only the question head trains) from phase
              22's viewpoint output, at its max_seq_length 768 (the
              classifier configs keep 512, whose position table both
              packages refuse), 4 iterations: launches per iteration
              K1f 12, K2f 25 and no backward kernel, ms per iteration, the
              encoder and nav decoder bit for bit as in the viewpoint
              checkpoint, finite val metrics; then classifier_val.json on the
              same output gives the same metrics;
 25. oscar:   an HF-layout pytorch_model.bin at BERT-base shapes from a
              seeded generator, then ``run viewpoint --debug
              --model_name_or_path <dir>`` for 2 iterations: the encoder's
              BERT equals the file's converted tensors before the first step
              and is within 2 Adam steps of them after; launches as phase 22;
 26. datagen: ``run datagen --debug --add_r2r_data``: the NDH and R2R
              files of each split equal generate_pretrain_examples;
 27. speaker: the SpeakerAgent at run_configs/pipeline/speaker.json's width
              (batch 32, 40-step trusted-path trajectories, 80 words, rnn
              512, wemb 256, feature dropout 0.6, movement frame, 2048 + 4
              features, vocabulary 30522 with word ids from a seed) on phase
              10's world: 2 warm-up and 8 train steps timed by CUDA events,
              no K1-K5 launch, the idle share, peak memory; a greedy
              generation batch (ms), the greedy and sampled decode loops
              under torch.cuda.set_sync_debug_mode("error"), augment's
              read-backs a batch (one); fp32 with the dropouts at 0, card vs
              CPU: one step on 4 items (loss, gradients, the Adam update)
              and the greedy tokens of 16 walks up to each one's first near
              tie (run before phase 22);
 28. speaker chain: ``run speaker`` (speaker.json) 4 iterations, --resume
              to 6 (checkpoints 2, 4, 6, the Adam count), ``run augment``
              (augment.json, --aug_targets) of 64 records from it, ``run
              viewpoint --aug_data`` (ndh_oscar_setting.json) 2 iterations:
              the train split grows by 64, launches per iteration 0 (speaker)
              and K1f 12, K1b 12, K2f 25, K2b 25 (fine-tune), ms per
              iteration beside phase 22's viewpoint iteration;
 29. options: VisitronBert with history K/V at BERT-base width (bf16,
              batch 16, 128 fresh tokens over 384 history tokens a layer):
              launches (K2f 25, K1f 0: the plain attention), ms, and fp32
              card vs CPU on 2 items; the bidirectional OscarEncoder fp32
              card vs CPU (zeros at the pads); ``run viewpoint --debug
              --no_use_fused_layernorm`` 2 iterations (K1f 12, K1b 12, K2f 0,
              K2b 0 an iteration) beside phase 22's iteration;
 30. scene:   the scene extractor (ResNet-152, 640x480, VFOV 60) in faces
              mode on seeded 1024 px uint8 faces, 2 panoramas (72 views) a
              forward, bf16 and fp32: frames/s (CUDA events), the idle share
              (torch.profiler), peak memory, conv FLOPs a view and their
              share of 989 / 67 TFLOP/s, the bf16-vs-fp32 drift, fp32 card
              vs CPU on 2 views;
 31. regions: the bottom-up Faster R-CNN (ResNet-101, 1601 classes, 401
              attributes, 300 ROIs, pre-NMS 6000) from a seeded caffe-layout
              dump, 600x600 at VFOV 80, 6 views a dispatch, fp32 and bf16:
              frames/s, the idle share, peak memory, nms_fixed's ms and
              launches a dispatch (run once under
              torch.cuda.set_sync_debug_mode("error")), the host's
              post-processing of one view, fp32 card vs CPU on one view (the
              kept proposals up to the first near tie);
 32. extract: ``run extract_scene`` with a seeded torchvision-layout
              ResNet-152 .pth and ``run extract_regions`` with a seeded .npz
              dump and 1601 / 401-line vocabularies over a 2-viewpoint scan
              of 1024 px skybox JPEGs at full geometry: the TSV read back,
              verify_region_store, no K1-K5 launch, ms a viewpoint;
 33. dp world of one: ``chip_smoke.py --dp-phase world1`` under
              ``python -m torch.distributed.run --standalone
              --nproc_per_node 1`` (NCCL on cuda:0, checked): the NDH dp
              step at phase 11's set-up (batch 64) and the S 768
              pretraining step (batch 16) under dp, ZeRO-1 and FSDP, and
              one S 1024 FSDP step with ``use_flash_attention`` (batch 8,
              K5f), each in fp32 with the dropouts at 0 against the
              single-device step from the same start (loss within 1e-5
              relative, parameters within 2 lr and 1e-2 lr for 99% of
              them; bit-for-bit equality reported, beside whether the
              single-device step run twice is equal bit for bit), the collective
              counters (the counts' and the gradients' all-reduces, no
              reduce-scatter or all-gather at world 1); then the bf16
              steps timed in one process: NDH plain, dp and dp + ZeRO-1,
              pretraining plain, dp, ZeRO-1 and FSDP (ms a step, launches
              a step checked as phases 11 and 12, collectives a step, peak
              memory, and a torch.profiler step: busy time, idle share,
              the NCCL kernels' device time);
 34. dp CLI: ``torch.distributed.run --nproc_per_node 1 -m
              visitron_torch.run viewpoint --debug --zero1`` (4 iterations,
              checkpoints 2 and 4, val) and ``pretrain --debug --fsdp``
              (one epoch), both at once: checkpoints in the single-device
              layout, finite losses, seconds with start-up (contended: the
              two runs share the card and the host);
 35. dp two ranks: ``--dp-phase two`` with 2 processes: NCCL on two
              cards, else gloo with CUDA tensors on cuda:0 (NCCL refuses
              two ranks on one card); a probe of the collectives the group
              carries on those tensors; each arm (NDH dp, NDH ZeRO-1,
              pretraining ZeRO-1 and FSDP) whose collectives it carries
              runs on the two halves of a batch against rank 0's
              one-process step on the whole batch (fp32, dropouts 0, as
              phase 33), with the host time of both runs (fresh state and
              the step or steps); a line names the arms that ran and those
              that could not, which count as not passed (the NDH dp arm
              must run);
 36. mesh kernels (in the main process, after phase 9): K1f/K1b (B 64, S
              256), K4f/K4b (B 16, S 768) and K5f/K5b (B 16, S 1024)
              on 6 of 12 heads, as a tp or sp rank's model calls them, the
              rank (dp 1, tp 1) of a (2, 2) mesh (the seed folded by 1000003 +
              7919, past int32): forward and backward (bf16, rate 0.1)
              against the twins with the folded seed, one launch of each
              kernel, the keep mask read from the outputs (fp32: q = k =
              0, v the identity on one block of keys) equal to the twins'
              bit for bit, and the device times of the 6-head calls
              beside the 12-head calls';
 37. mesh two ranks: ``--mp-phase two`` with 2 processes, NCCL on two
              cards, else gloo with CUDA tensors on cuda:0: a probe of the
              collectives, then the arms: the tp 2 NDH teacher-forced step
              (batch 64), tp 2
              and sp 2 pretraining at S 768 (batch 16), cp 2 (the ring) at
              S 1024 (batch 8), fp32 with the dropouts at 0, against rank
              0's one-process step on the whole batch with phase 35's
              bounds, the kernels' launches a step checked, the
              collectives, the bytes staged through the host and the host
              time of both runs.  Every backend must carry every
              collective and run every arm: under gloo with CUDA tensors
              the ring's send/recv goes through the host
              (``parallel.p2p``, counted in ``parallel.p2p_host_staged``);
 38. mesh CLI: ``torch.distributed.run --nproc_per_node 1 -m
              visitron_torch.run pretrain --debug --mesh_sp 1`` (one
              epoch at batch 8) and ``viewpoint --debug --mesh_tp 1`` (2
              iterations), both at once: checkpoints, finite losses,
              seconds with start-up (contended: the two runs share the card
              and the host);
 39. pipeline two ranks: ``--pp-phase two`` with 2 processes, NCCL on two
              cards, else gloo with CUDA tensors on cuda:0, whose stage
              transfers go through the host (``parallel.p2p_host_staged``,
              counted): BERT-base at S 768, batch 16, pp 2 (6 layers a
              stage), M 8 (microbatches of 2).  Two fp32 steps with the
              dropouts at 0 against rank 0's one-process ``PretrainTrainer``
              steps (phase 35's bounds), then bf16 steps with the dropouts
              on (finite losses), timed (ms a step, each rank's host time in
              receives, the bytes staged, peak memory, a profiled step),
              each rank's launches a step checked: K4f/K4b 6 x 8, K2f/K2b
              2 x 6 x 8 + 1 (rank 0's embedding LayerNorm, the last rank's
              MLM LayerNorm), K3f/K3b 1 on the last rank only;
 40. pipeline CLI: ``run pretrain --debug --mesh_pp 2`` (one epoch, then
              ``--num_epochs 2 --resume``) on two ranks: with two or more
              cards ``torch.distributed.run --nproc_per_node 2 -m
              visitron_torch.run`` (NCCL, a card a rank), else
              ``--pp-phase cli`` under torchrun, whose ranks join gloo on
              cuda:0 and call ``run.main`` (stage transfers staged through
              the host; each rank's launches counted in each run).
              Checkpoints at epochs 1 and 2, the parameters in the
              single-device layout (a one-process ``PretrainTrainer``
              loads them), the optimizer state in the pipeline's
              ``{"rest", "stages"}`` layout, the resume logged, every
              rank's validation logged, finite losses;
 41. T 40 (in the main process, after phase 21): bench.py's long NDH
              workload (BENCH_EPISODE_LEN=40, trusted_path) at phase 10's
              world and width: the teacher-forced step (batch 64, the
              agent's dropouts; 2 warm-up and 3 timed steps), launches a
              step K1f 12, K1b 12, K2f 25, K2b 25 as at 10 steps (the
              encoder runs once an episode), ms a step, nav actions/s,
              the idle share, peak memory; the argmax serving rollout at
              40 steps (tools/bench_eval.py's serving_t40: trajectories on
              graph edges, K1f 12 and K2f 25 a batch, ms a batch, the
              decode loop of one batch under
              torch.cuda.set_sync_debug_mode("error")); one fp32 step with
              every dropout at 0 on a 2-item batch, card vs CPU, as phase
              11's; the bf16 forward and backward with
              ``BertConfig(remat=True)`` against one without from the same
              parameters, batch and dropout seeds (the loss equal bit for
              bit, the gradients within GRAD_TOL, K1f 24 and K2f 49 with
              remat, the peak memory of both) and the remat step's ms;
 42. bf16 Adam moments: the NDH step with ``bf16_adam_moments`` at phase
              11's set-up, two steps (launches as phase 11's, finite
              losses), the moments bf16 and the optimizer state half the
              bytes of the fp32-moment state of the same parameters; two
              fp32 steps with every dropout at 0 on a 2-item batch, card vs
              CPU: the parameters within lr * 1e-2 wherever both steps'
              gradients exceed 1e-2, within 4 lr elsewhere;
 43. realscale: the deployment's world (tools/realscale_smoke.py's, through
              visitron_torch.testing.realscale): 90 scans x 120 viewpoints =
              10,800 viewpoints x 36 views x 2048-d, the scene table packed
              as bf16 on the host in page-locked memory (no fp32 copy of the
              whole table) and placed with one copy: 1,592,524,800 bytes on
              the card, checked; two teacher-forced steps of BERT-base bf16
              at batch 64 at T 10 planner_path and at T 40 trusted_path
              (finite losses; launches a step K1f 12, K1b 12, K2f 25, K2b
              25, as on phase 10's world); the argmax serving rollout at T
              10 on this runtime (trajectories on graph edges, K1f 12 and
              K2f 25 a batch, the decode loop of one batch under
              torch.cuda.set_sync_debug_mode("error")); the host seconds of
              the world, the pack, the candidate tables and the placement,
              the host's resident and peak memory, the card's memory after
              placement and its peak over the steps, and in the same call
              on this world and on phase 10's 240-viewpoint world (35.4 MB,
              inside the 50 MB L2): the T 10 step's ms (median of 3 after 2
              warm-up) and the device time of one episode's table reads
              (gather_step_inputs at its 10 steps, torch.profiler);
 44. science: the end-to-end science run (tools/synthetic_e2e.py's,
              through visitron_torch.testing.science) on its seed-5 world of
              4 scans x 50 viewpoints: BERT-base bf16, T 10 planner_path,
              batch 32, Adam 1e-4, 1000 iterations (the tool's default),
              the argmax rollouts of the first 48 training episodes scored
              by Evaluator before and after; launches a step as phase
              11's; gates fixed before
              any run: every loss finite, the mean loss of the last 50
              steps <= 0.6 x that of the first 50, Goal Progress after -
              before >= 1.0 m, Success Rate after > before; nav actions/s
              over the training loop (batch x 10 a step).  It runs right
              after phase 2, before any torch.profiler session.
 45. aug_ab   the back-translation A/B (tools/aug_ab.py's chain, through
              visitron_torch.testing.aug_ab) on its seed-13
              directional-language world at its widths: the speaker (LSTM
              128, feature dropout 0.6, movement frame) 600 iterations, 300
              captioned walks, a fresh follower (BERT 2 x 128, bf16) 250
              iterations an arm, baseline and aug, each scored on the 64
              held-out episodes; gates fixed in PERF.md before its first
              run at these settings on the card: records == instances ==
              300, every record a walk over graph edges, no K1-K5 launch in
              the speaker's steps or the augment, the follower's launches a
              step as counted from the code (K2f / K2b 5, no K1: head dim
              32), its evaluation's (K2f 5 a batch), the speaker's word CE
              at its last log over its first, the captions' parse and hop
              accuracy, the hop accuracy over that of the same captions
              rotated one walk on (a speaker blind to its trajectory scores
              the same on both), each arm's loss ratio; ΔGP printed, not
              gated.  It runs right after phase 44, in the main process.

The line before the last is a JSON object listing each kernel with its
launches in its path's run (K1f and K2f: serving; K1b and K2b: train; K3f,
K3b, K4f and K4b: pretrain; K5f and K5b: long-context pretrain), max error,
and times, for the four NDH kernels their launches in the timed runs of
phases 11, 16 and 17 (``path_launches``), and for every kernel its launches
per iteration of phase 22's viewpoint and pretrain runs and of phases
23-25's, 28's, 29's and 32's runs (``cli_launches``), in phases 29-31's
paths (``option_and_feature_launches``), its launches a step in phase 33's
data-parallel runs (``dp_launches``), in phase 37's arms
(``mp_launches``), on each rank of phase 39's pipeline
(``pp_launches``), in phase 41's T 40 step, serving batch and remat
forward and backward (``t40_launches``) and a step of phase 42's
bf16-moment step (``bf16_moments_launches``), and the count of device
times that no torch.profiler session gave (``device_times_unmeasured``;
such a time is null, and the run fails where K1f, K2f, K1b or K2b has
none); beside the kernels, ``realscale`` (phase 43: the viewpoints, the
table's bytes on the card, the launches a step at T 10 and T 40 and a
serving batch, the peak GiB over the steps, the T 10 step's ms and the table
reads' device ms on both worlds), ``science`` (phase 44: the iterations,
GP, SR, SPL and nDTW before and after, the mean loss of the first and of
the last 50 steps, nav actions/s), ``aug_ab`` (phase 45: the captions'
fidelity and that of the control, the captions rotated one walk on, each
arm's held-out GP, SR, SPL and nDTW, ΔGP, the iterations, records,
seconds and the launches of the speaker and augment, a follower step and
an eval batch) and ``ndh_step_profile`` (phase 11's 3 profiled
steps: ms, busy ms, idle share and kernels a step, device ms by kind); the
last line is ``{"ok": true, "device": {...}}``.  A rehearsal prints
neither; it runs phases 43-45 on 2 scans x 12 viewpoints, 32-d, and 20
iterations (phase 45: 200 speaker and 20 follower iterations, 16 records,
one BERT layer), and reports the learning gates without enforcing them at
that size.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import json
import math
import os
import resource
import subprocess
import sys
import tempfile
import time

import numpy as np

# Kineto tears CUPTI down after each torch.profiler session and sets it up
# again at the next; now and then a session after such a teardown records no
# device kernel (seen on the H100, several sessions in a row).  Kept up, CUPTI
# records every session.  Set before torch loads Kineto.
os.environ.setdefault("TEARDOWN_CUPTI", "0")

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.func import functional_call  # noqa: E402

from visitron_torch import _build
from visitron_torch import geometry as geo
from visitron_torch import parallel
from visitron_torch.agents import NavEpisodeBatcher, NavRuntime, ViewpointAgent, decoding
from visitron_torch.agents.decoding import select_action
from visitron_torch.agents.viewpoint import gather_step_inputs
from visitron_torch.data import (SceneFeatureTable, WordPieceTokenizer,
                                 build_wordpiece_vocab)
from visitron_torch.data.datasets import build_nav_instances
from visitron_torch.evaluation import Evaluator
from visitron_torch.models import BertConfig
from visitron_torch.models.layers import DropoutRng
from visitron_torch.models.lstm import masked_lstm_scan
from visitron_torch.ops import attention as attn_ops
from visitron_torch.ops.attention import (attention_supports_fused, flash_attention,
                                          flash_attention_bwd,
                                          flash_attention_bwd_reference,
                                          flash_attention_reference,
                                          fused_attention, fused_attention_bwd,
                                          fused_attention_bwd_reference,
                                          fused_attention_packed,
                                          fused_attention_packed_bwd,
                                          fused_attention_packed_bwd_reference,
                                          fused_attention_packed_reference,
                                          fused_attention_reference)
from visitron_torch.ops import crossentropy as ce_ops
from visitron_torch.ops.crossentropy import (fused_masked_softmax_ce,
                                             fused_masked_softmax_ce_bwd,
                                             masked_softmax_ce_bwd_reference,
                                             masked_softmax_ce_reference)
from visitron_torch.ops.layernorm import (fused_add_layernorm, fused_add_layernorm_bwd,
                                          layernorm_bwd_reference, layernorm_reference)
from visitron_torch.parallel.pipeline import PipelinePretrainTrainer
from visitron_torch.train import PretrainTrainer
from visitron_torch.train.optim import agent_optimizer, apply_updates, tree_leaves
from visitron_torch.testing import SyntheticWorld, aug_ab, nav_profile, realscale, science
from visitron_torch.testing.nav_profile import device_kernels
from visitron_torch.testing.synthetic import _TARGETS, _WORDS

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
SEED = 0
# Tolerances of kernel against plain twin.  bf16: both round the output (and
# the probabilities) to bf16 at different points, so a few bf16 ulps of the
# value; fp32: summation order only.
TOL = {torch.bfloat16: (2e-2, 1e-2), torch.float32: (1e-4, 1e-4)}  # (atol, rtol)
# Gradients of K1b: bf16 rounds a_eff and ds where the twin does and sums in
# another order, so an output may differ by about one bf16 ulp (the largest
# error seen on an H100 at the shapes below was 3.9e-3); the limit is about
# twice that, and rtol 1e-2 covers one ulp (2^-7 relative) at any magnitude.
# fp32: summation order only.
GRAD_TOL = {torch.bfloat16: (8e-3, 1e-2), torch.float32: (1e-4, 1e-4)}
# dgamma/dbeta: fp32 sums over R = 16K-32K rows in another order.
SUM_TOL = (1e-3, 1e-4)
# K3: ce and lse are fp32 sums over V in another order.  dlogits: the kernel
# and the twin round the same fp32 value to bf16 from lse values that may
# differ in the last fp32 bits, so one bf16 ulp (2^-7 relative at most);
# fp32: exp's rounding.  The values are probabilities (~1/V), so the
# absolute part is small.
CE_TOL = (1e-4, 1e-5)
CE_GRAD_TOL = {torch.bfloat16: (1e-6, 8e-3), torch.float32: (1e-7, 1e-5)}
AGREE_TOL = (1e-3, 1e-3)  # card vs CPU, fp32, whole model: (atol, rtol)
ATTN_SOURCE = ("visitron_torch/csrc/attention.cu",
               "visitron_tpu/ops/attention.py:705")
LN_SOURCE = ("visitron_torch/csrc/layernorm.cu",
             "visitron_tpu/ops/layernorm.py:95")
ATTN_BWD_REPLACES = "visitron_tpu/ops/attention.py:742"
LN_BWD_REPLACES = "visitron_tpu/ops/layernorm.py:123"
CE_SOURCE = "visitron_torch/csrc/crossentropy.cu"
CE_REPLACES = ("visitron_tpu/ops/crossentropy.py:53", "visitron_tpu/ops/crossentropy.py:91")
ATTN4_REPLACES = ("visitron_tpu/ops/attention.py:487", "visitron_tpu/ops/attention.py:529")
# K5b replaces the two Pallas kernels _bwd_dkv_kernel (:146) and _bwd_dq_kernel (:191).
FLASH_REPLACES = ("visitron_tpu/ops/attention.py:100", "visitron_tpu/ops/attention.py:146")
H100_PEAK_BF16 = PEAK_OPS_PER_S[torch.bfloat16]

REHEARSAL = False


def say(msg: str) -> None:
    print(("[rehearsal, CPU, plain twins] " if REHEARSAL else "") + msg, flush=True)


LAP = [time.perf_counter()]


def lap(what: str) -> None:
    """The seconds since the last lap (or the start), for the phases named."""
    now = time.perf_counter()
    say(f"[time] {what}: {now - LAP[0]:.1f} s")
    LAP[0] = now


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def check_close(name: str, got: torch.Tensor, want: torch.Tensor, tol) -> float:
    atol, rtol = tol
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    bad = diff > atol + rtol * want.float().abs()
    say(f"  {name}: max|err| {err:.3g} (tolerance {atol:g} + {rtol:g}*|ref|)"
        f"{'' if not bad.any() else f', {int(bad.sum())} values outside'}")
    if bad.any() or not torch.isfinite(got.float()).all():
        fail(f"{name}: kernel disagrees with its plain twin")
    return err


def sync() -> None:
    if not REHEARSAL:
        torch.cuda.synchronize()


def check_deterministic(name: str, fn, outputs: str = "dq/dk/dv") -> None:
    """Two launches of a backward on the same inputs give its outputs equal
    bit for bit (no atomics: the result does not depend on block order)."""
    first, second = fn(), fn()
    sync()
    same = all(torch.equal(x, y) for x, y in zip(first, second))
    say(f"  {name}: {outputs} of two launches equal bit for bit: {same}")
    if not same:
        fail(f"{name}: two launches on the same inputs disagree")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms per call: CUDA events around ``iters`` calls after warm-up."""
    for _ in range(warmup):
        fn()
    if REHEARSAL:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# Tags of the device times that no profiling session gave.
UNMEASURED: list = []
CUPTI_WARM = False


def device_ms(fn, calls: int = 5) -> dict | None:
    """Device time of one call, by kernel name: the durations of the kernels
    ``fn`` launches under torch.profiler (CUPTI), averaged over ``calls``
    calls.  Unlike time_ms it leaves out the host: back-to-back calls whose
    host work outlasts their kernels time the host's issue rate instead.
    None when no session recorded a device kernel."""
    global CUPTI_WARM
    from torch.profiler import ProfilerActivity, profile

    if not CUPTI_WARM:
        # The first session sets CUPTI up; its records are not read.
        with profile(activities=[ProfilerActivity.CUDA]):
            fn()
            torch.cuda.synchronize()
        CUPTI_WARM = True
    fn()
    torch.cuda.synchronize()
    # A session that records no device kernel is taken again rather than
    # read as a time of 0; a time that no session gives is not measured.
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        by_name: dict = {}
        for name, us in device_kernels(prof):
            by_name[name] = by_name.get(name, 0.0) + us / 1e3 / calls
        if by_name:
            return by_name
        say("  (torch.profiler recorded no device kernel; profiling again)")
        time.sleep(1.0 + attempt)
    say("  (torch.profiler recorded no device kernel in three sessions: not measured)")
    return None


def not_measured(tag: str, *keys: str) -> dict:
    """``keys`` as None (JSON null) for a device time no session gave,
    counted in UNMEASURED."""
    say(f"  device time {tag}: not measured")
    UNMEASURED.append(tag)
    return dict.fromkeys(keys)


# The attention backward's kernels, by a part of their names.
BWD_KERNELS = (("di", "attention_bwd_di"), ("dq", "attention_bwd_dq"),
               ("dk/dv", "attention_bwd_dkv"))
# K2b's at H 768: the row kernel and the final sum.
LN_BWD_KERNELS = (("rows", "add_layernorm_bwd_ring"), ("final sum", "add_layernorm_bwd_sum"))


def say_bwd_device_ms(tag: str, kernel, library, parts=BWD_KERNELS,
                      library_name: str = "sdpa backward") -> dict:
    """Print the device times (device_ms) of a backward, split into its
    kernels (``parts``), and of its yardstick; return them.  Nothing in a
    rehearsal."""
    if REHEARSAL:
        return {}
    split, lib = device_ms(kernel), device_ms(library)
    if split is None or lib is None:
        return not_measured(tag, "device_ms", "library_device_ms")
    by_part = {short: sum(ms for name, ms in split.items() if key in name)
               for short, key in parts}
    by_part["other"] = sum(ms for name, ms in split.items()
                           if not any(key in name for _, key in parts))
    total, lib = sum(split.values()), sum(lib.values())
    say(f"  device time {tag} (torch.profiler, mean of 5 calls): kernel {total:.4f} ms ("
        + ", ".join(f"{k} {v:.4f}" for k, v in by_part.items() if v) + f"), {library_name} "
        f"{lib:.4f} ms, kernel / yardstick {total / lib:.2f}")
    return {"device_ms": total, "device_split": by_part, "library_device_ms": lib}


def say_fwd_device_ms(tag: str, kernel, library, step=None,
                      library_name: str = "sdpa forward") -> dict:
    """Print the device times (device_ms) of a forward (attention: at rate 0
    without the lse) and of its yardstick, and the factor kernel / yardstick,
    and, given ``step``, of the forward in its train step's call (rate 0.1,
    the lse); return them.  Nothing in a rehearsal."""
    if REHEARSAL:
        return {}
    total, lib = device_ms(kernel), device_ms(library)
    if total is None or lib is None:
        return not_measured(tag, "device_ms", "library_device_ms",
                            *(("step_device_ms",) if step is not None else ()))
    total, lib = sum(total.values()), sum(lib.values())
    say(f"  device time {tag} (torch.profiler, mean of 5 calls): kernel {total:.4f} ms, "
        f"{library_name} {lib:.4f} ms, kernel / yardstick {total / lib:.2f}")
    out = {"device_ms": total, "library_device_ms": lib}
    if step is not None:
        step_ms = device_ms(step)
        if step_ms is None:
            out.update(not_measured(f"{tag}, train step's call", "step_device_ms"))
        else:
            out["step_device_ms"] = sum(step_ms.values())
            say(f"  device time of the train step's call (rate 0.1, lse): kernel "
                f"{out['step_device_ms']:.4f} ms, train / eval "
                f"{out['step_device_ms'] / total:.2f}")
    return out


def bound_ms(nbytes: float, ops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def copies_for_cold_l2(nbytes: int) -> int:
    """Input sets to cycle through so that one pass exceeds the 50 MB L2."""
    return max(1, -(-200_000_000 // max(nbytes, 1)))


# -- phase 1 -------------------------------------------------------------------

def phase_device() -> dict:
    if REHEARSAL:
        say("device: cpu (nvidia-smi not run)")
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on an H100")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    say(f"device: {kind} (count {count}), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    say(f"nvidia-smi: {smi}")
    return {"platform": "gpu", "kind": kind, "count": count, "nvidia_smi": smi}


# -- phase 2 -------------------------------------------------------------------

def phase_build() -> None:
    if REHEARSAL:
        say("build: skipped (no nvcc)")
        return
    _build.load()
    info = _build.build_info
    say(f"build: {'compiled' if info['compiled'] else 'reused'} {info['library']} "
        f"in {info['seconds']:.2f} s")
    for source, lines in info["ptxas"].items():
        for line in lines:
            say(f"  {source}: {line}")
    if info["compiled"]:  # a reused library comes without ptxas lines
        warnings = [ln for lines in info["ptxas"].values() for ln in lines
                    if _build.PTXAS_WARNING.search(ln)]
        say(f"  ptxas performance warnings (C7xxx): {len(warnings)}")


# -- phase 3: K1 -------------------------------------------------------------------

def attention_inputs(b, s, h, d, dtype, device, g):
    qkv = torch.randn(b, s, 3 * h * d, generator=g, device=device).to(dtype)
    lengths = torch.randint(s // 2, s + 1, (b,), generator=g, device=device)
    bias = torch.where(torch.arange(s, device=device)[None] < lengths[:, None],
                       0.0, -1e9).float().contiguous()
    return qkv, bias


def phase_k1(device, shapes) -> dict:
    """Returns {S: timing dict} at the bf16 serving shapes."""
    say("K1 fused_attention_packed vs plain twin")
    g = torch.Generator(device=device).manual_seed(SEED)
    b, h, d = shapes["batch"], shapes["heads"], shapes["head_dim"]
    out = {}
    for s in shapes["seqs"]:
        for dtype, rate in ((torch.bfloat16, 0.0), (torch.float32, 0.0),
                            (torch.bfloat16, 0.1), (torch.float32, 0.1)):
            if rate > 0 and s != shapes["seqs"][0]:
                continue
            qkv, bias = attention_inputs(b, s, h, d, dtype, device, g)
            q, k, v = qkv.split(h * d, dim=-1)
            seed = 1234 if rate > 0 else None
            got, lse = fused_attention_packed(q, k, v, bias, h, seed, rate, need_lse=True)
            want, lse_want = fused_attention_packed_reference(q, k, v, bias, h, seed,
                                                              rate, need_lse=True)
            sync()
            tag = f"B{b} S{s} H{h} D{d} {str(dtype)[6:]} rate {rate}"
            err = check_close(f"out {tag}", got, want, TOL[dtype])
            check_close(f"lse {tag}", lse, lse_want, TOL[torch.float32])
            if dtype != torch.bfloat16 or rate > 0:
                continue
            n = 1 if REHEARSAL else copies_for_cold_l2(qkv.numel() * qkv.element_size())
            sets = [(qkv, bias)] + [attention_inputs(b, s, h, d, dtype, device, g)
                                    for _ in range(n - 1)]
            split = [(x.split(h * d, dim=-1), kb) for x, kb in sets]
            masks = [kb.to(dtype)[:, None, None, :] for _, kb in sets]
            it = iter(range(10 ** 9))

            def kernel():
                (q_, k_, v_), kb = split[next(it) % len(split)]
                fused_attention_packed(q_, k_, v_, kb, h)

            def plain():
                (q_, k_, v_), kb = split[next(it) % len(split)]
                fused_attention_packed_reference(q_, k_, v_, kb, h)

            def library():
                i = next(it) % len(split)
                four = [t.view(b, s, h, d).transpose(1, 2) for t in split[i][0]]
                F.scaled_dot_product_attention(*four, attn_mask=masks[i])

            ms = time_ms(kernel)
            plain_ms = time_ms(plain, iters=5, warmup=1)
            lib_ms = time_ms(library)
            nbytes = 4 * b * s * h * d * qkv.element_size() + b * s * 4
            ops = 4 * b * h * s * s * d
            bms, by = bound_ms(nbytes, ops, dtype)
            say(f"  time {tag}: kernel {ms:.4f} ms, plain twin {plain_ms:.4f} ms, "
                f"sdpa {lib_ms:.4f} ms, bound {bms:.4f} ms ({by}: {nbytes / 1e6:.1f} MB, "
                f"{ops / 1e9:.2f} GFLOP)")
            out[s] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                      "bound_ms": bms, "bound_by": by, "max_abs_err": err,
                      **say_fwd_device_ms(tag, kernel, library)}
    return out


# -- phase 4: K2 -------------------------------------------------------------------

def ln_inputs(rows, hidden, dtype, device, g):
    x = torch.randn(rows, hidden, generator=g, device=device).to(dtype)
    res = torch.randn(rows, hidden, generator=g, device=device).to(dtype)
    return x, res


def phase_k2(device, shapes) -> dict:
    """Returns {rows: timing dict} for the bf16 residual variant."""
    say("K2 fused_add_layernorm vs plain twin")
    g = torch.Generator(device=device).manual_seed(SEED + 1)
    hidden = shapes["hidden"]
    gamma = (1.0 + 0.1 * torch.randn(hidden, generator=g, device=device)).contiguous()
    beta = (0.1 * torch.randn(hidden, generator=g, device=device)).contiguous()
    eps = 1e-12
    out = {}
    for rows in shapes["rows"]:
        for dtype in (torch.bfloat16, torch.float32):
            x, res = ln_inputs(rows, hidden, dtype, device, g)
            for with_res in (True, False):
                r = res if with_res else None
                got = fused_add_layernorm(x, r, gamma, beta, eps)
                want = layernorm_reference(x, r, gamma, beta, eps)
                sync()
                tag = f"R{rows} H{hidden} {str(dtype)[6:]} residual {with_res}"
                err = check_close(tag, got, want, TOL[dtype])
                if dtype != torch.bfloat16:
                    continue
                elt = x.element_size()
                n = 1 if REHEARSAL else copies_for_cold_l2(2 * x.numel() * elt)
                sets = [(x, res)] + [ln_inputs(rows, hidden, dtype, device, g)
                                     for _ in range(n - 1)]
                it = iter(range(10 ** 9))

                def pick():
                    x_, r_ = sets[next(it) % len(sets)]
                    return x_, (r_ if with_res else None)

                def kernel():
                    fused_add_layernorm(*pick(), gamma, beta, eps)

                def plain():
                    layernorm_reference(*pick(), gamma, beta, eps)

                def library():
                    x_, r_ = pick()
                    F.layer_norm(x_ if r_ is None else x_ + r_, (hidden,),
                                 gamma.to(dtype), beta.to(dtype), eps)

                ms = time_ms(kernel, iters=50)
                plain_ms = time_ms(plain)
                lib_ms = time_ms(library, iters=50)
                nbytes = (3 if with_res else 2) * rows * hidden * elt + 2 * hidden * 4
                bms, by = bound_ms(nbytes, 10 * rows * hidden, torch.float32)
                say(f"  time {tag}: kernel {ms:.4f} ms, plain twin {plain_ms:.4f} ms, "
                    f"F.layer_norm {lib_ms:.4f} ms, bound {bms:.4f} ms "
                    f"({by}: {nbytes / 1e6:.1f} MB)")
                dev = say_fwd_device_ms(tag, kernel, library, library_name="F.layer_norm")
                if with_res:
                    out[rows] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                                 "bound_ms": bms, "bound_by": by, "max_abs_err": err,
                                 **dev}
    return out


# -- phase 5: K1b ----------------------------------------------------------------

def phase_k1b(device, shapes) -> dict:
    """Returns {S: timing dict} at the bf16 train shapes."""
    say("K1b fused_attention_packed_bwd vs plain twin")
    g = torch.Generator(device=device).manual_seed(SEED + 2)
    b, h, d = shapes["batch"], shapes["heads"], shapes["head_dim"]
    out = {}

    def inputs(s, dtype, rate, seed):
        qkv, bias = attention_inputs(b, s, h, d, dtype, device, g)
        q, k, v = qkv.split(h * d, dim=-1)
        dout = torch.randn(b, s, h * d, generator=g, device=device).to(dtype)
        _, lse = fused_attention_packed(q, k, v, bias, h, seed, rate, need_lse=True)
        return q, k, v, bias, dout, lse

    for s in shapes["seqs"]:
        for dtype, rate in ((torch.bfloat16, 0.0), (torch.float32, 0.0),
                            (torch.bfloat16, 0.1), (torch.float32, 0.1)):
            if rate > 0 and s != shapes["seqs"][0]:
                continue
            seed = 1234 if rate > 0 else None
            args = inputs(s, dtype, rate, seed)
            got = fused_attention_packed_bwd(*args, h, seed, rate)
            want = fused_attention_packed_bwd_reference(*args, h, seed, rate)
            sync()
            tag = f"B{b} S{s} H{h} D{d} {str(dtype)[6:]} rate {rate}"
            err = max(check_close(f"{name} {tag}", x, y, GRAD_TOL[dtype])
                      for name, x, y in zip(("dq", "dk", "dv"), got, want))
            if rate > 0:
                say("  (the twin's keep mask is K1f's, checked in phase K1: the two "
                    "kernels' masks agree)")
            if dtype == torch.bfloat16:
                check_deterministic(f"K1b {tag}",
                                    lambda: fused_attention_packed_bwd(*args, h, seed, rate))
            if dtype != torch.bfloat16 or rate > 0:
                continue
            elt = args[0].element_size()
            n = 1 if REHEARSAL else copies_for_cold_l2(4 * b * s * h * d * elt)
            sets = [args] + [inputs(s, dtype, 0.0, None) for _ in range(n - 1)]
            it = iter(range(10 ** 9))

            def kernel():
                fused_attention_packed_bwd(*sets[next(it) % len(sets)], h)

            def plain():
                fused_attention_packed_bwd_reference(*sets[next(it) % len(sets)], h)

            graphs = []
            for q_, k_, v_, kb, do_, _ in sets:
                four = [t.view(b, s, h, d).transpose(1, 2).detach().requires_grad_()
                        for t in (q_, k_, v_)]
                o4 = F.scaled_dot_product_attention(
                    *four, attn_mask=kb.to(dtype)[:, None, None, :])
                graphs.append((o4, four, do_.view(b, s, h, d).transpose(1, 2)))

            def library():
                o4, four, do4 = graphs[next(it) % len(graphs)]
                torch.autograd.grad(o4, four, do4, retain_graph=True)

            ms = time_ms(kernel)
            plain_ms = time_ms(plain, iters=3, warmup=1)
            lib_ms = time_ms(library)
            nbytes = 7 * b * s * h * d * elt + b * h * s * 4 + b * s * 4
            ops = 10 * b * h * s * s * d
            bms, by = bound_ms(nbytes, ops, dtype)
            say(f"  time {tag}: kernel {ms:.4f} ms, plain twin {plain_ms:.4f} ms, "
                f"sdpa backward {lib_ms:.4f} ms, bound {bms:.4f} ms ({by}: "
                f"{nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP; the two kernels "
                f"do {1.8 * ops / 1e9:.2f}, {1.8 * ops / ms / 1e9:.1f} TFLOP/s)")
            out[s] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                      "bound_ms": bms, "bound_by": by, "max_abs_err": err,
                      **say_bwd_device_ms(tag, kernel, library)}
            del graphs
    return out


# -- phase 6: K2b ------------------------------------------------------------------

def phase_k2b(device, shapes) -> dict:
    """Returns {rows: timing dict} for the bf16 residual variant."""
    say("K2b fused_add_layernorm_bwd vs plain twin")
    g = torch.Generator(device=device).manual_seed(SEED + 3)
    hidden = shapes["hidden"]
    gamma = (1.0 + 0.1 * torch.randn(hidden, generator=g, device=device)).contiguous()
    eps = 1e-12
    out = {}

    def inputs(rows, dtype):
        dy = torch.randn(rows, hidden, generator=g, device=device).to(dtype)
        return (dy, *ln_inputs(rows, hidden, dtype, device, g))

    for rows in shapes["rows"]:
        for dtype in (torch.bfloat16, torch.float32):
            dy, x, res = inputs(rows, dtype)
            for with_res in (True, False):
                r = res if with_res else None
                got = fused_add_layernorm_bwd(dy, x, r, gamma, eps)
                want = layernorm_bwd_reference(dy, x, r, gamma, eps)
                sync()
                tag = f"R{rows} H{hidden} {str(dtype)[6:]} residual {with_res}"
                err = check_close(f"dh {tag}", got[0], want[0], TOL[dtype])
                check_close(f"dgamma {tag}", got[1], want[1], SUM_TOL)
                check_close(f"dbeta {tag}", got[2], want[2], SUM_TOL)
                if dtype != torch.bfloat16:
                    continue
                check_deterministic(f"K2b {tag}", lambda: fused_add_layernorm_bwd(
                    dy, x, r, gamma, eps), "dh/dgamma/dbeta")
                elt = x.element_size()
                n = 1 if REHEARSAL else copies_for_cold_l2(4 * x.numel() * elt)
                sets = [(dy, x, res)] + [inputs(rows, dtype) for _ in range(n - 1)]
                it = iter(range(10 ** 9))

                def pick():
                    dy_, x_, r_ = sets[next(it) % len(sets)]
                    return dy_, x_, (r_ if with_res else None)

                def kernel():
                    fused_add_layernorm_bwd(*pick(), gamma, eps)

                def plain():
                    layernorm_bwd_reference(*pick(), gamma, eps)

                graphs = []
                for dy_, x_, r_ in sets:
                    xl, rl = x_.detach().requires_grad_(), r_.detach().requires_grad_()
                    gl = gamma.to(dtype).requires_grad_()
                    bl = torch.zeros(hidden, dtype=dtype, device=device,
                                     requires_grad=True)
                    y_ = F.layer_norm(xl + rl if with_res else xl, (hidden,), gl, bl, eps)
                    graphs.append((y_, [xl, rl, gl, bl] if with_res else [xl, gl, bl],
                                   dy_))

                def library():
                    y_, leaves, dy_ = graphs[next(it) % len(graphs)]
                    torch.autograd.grad(y_, leaves, dy_, retain_graph=True)

                ms = time_ms(kernel, iters=50)
                plain_ms = time_ms(plain)
                lib_ms = time_ms(library, iters=50)
                nbytes = (4 if with_res else 3) * rows * hidden * elt + 3 * hidden * 4
                bms, by = bound_ms(nbytes, 20 * rows * hidden, torch.float32)
                say(f"  time {tag}: kernel {ms:.4f} ms (with the sum of its partials), "
                    f"plain twin {plain_ms:.4f} ms, F.layer_norm backward "
                    f"{lib_ms:.4f} ms, bound {bms:.4f} ms ({by}: {nbytes / 1e6:.1f} MB)")
                dev = say_bwd_device_ms(tag, kernel, library, LN_BWD_KERNELS,
                                        "F.layer_norm backward")
                del graphs
                if with_res:
                    out[rows] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                                 "bound_ms": bms, "bound_by": by, "max_abs_err": err,
                                 **dev}
    return out


# -- phase 7: K3 ---------------------------------------------------------------------

def ce_inputs(rows, vocab, dtype, device, g, width=None):
    """Logits like the MLM head's, labels with ~10% ignored rows and a few
    outside [0, width), and a per-row cotangent.  ``width`` > ``vocab`` pads
    the logits with -inf columns to that width, as ``PretrainModel.heads``
    builds the buffer K3 reads (the vocabulary rounded up to a multiple of
    8); the labels stay below ``vocab`` or outside [0, width)."""
    width = width or vocab
    x = (3.0 * torch.randn(rows, vocab, generator=g, device=device)).to(dtype)
    if width > vocab:
        x = torch.cat([x, x.new_full((rows, width - vocab), -math.inf)], dim=1)
    labels = torch.randint(0, vocab, (rows,), generator=g, device=device)
    labels[::10] = -1
    labels[1::97] = width + 3
    cot = torch.rand(rows, generator=g, device=device)
    return x, labels, cot


def phase_k3(device, shapes) -> dict:
    """K3f and K3b against their twins at the MLM head's shape, on the
    vocabulary's own width and on the main path's (rounded up to a multiple
    of 8, the pad columns -inf); returns {"k3": timing, "k3b": timing} for
    bf16 at the main path's width."""
    say("K3 fused_masked_softmax_ce (forward and backward) vs plain twins")
    g = torch.Generator(device=device).manual_seed(SEED + 4)
    rows, vocab = shapes["rows"], shapes["vocab"]
    padded = vocab + -vocab % 8
    out = {}
    cases = [(dtype, width) for dtype in (torch.bfloat16, torch.float32)
             for width in dict.fromkeys((vocab, padded))]
    for dtype, width in cases:
        x, labels, cot = ce_inputs(rows, vocab, dtype, device, g, width)
        ce, lse = ce_ops._forward(x, labels)  # K3f with its lse
        want_ce, want_lse = masked_softmax_ce_reference(x, labels)
        dx = fused_masked_softmax_ce_bwd(x, labels, lse, cot)
        want_dx = masked_softmax_ce_bwd_reference(x, labels, lse, cot)
        sync()
        tag = f"R{rows} V{width}{f' (-inf past {vocab})' if width > vocab else ''} " \
              f"{str(dtype)[6:]}"
        err = check_close(f"ce {tag}", ce, want_ce, CE_TOL)
        check_close(f"lse {tag}", lse, want_lse, CE_TOL)
        valid = (labels >= 0) & (labels < width)
        if bool((ce[~valid] != 0).any()) or bool((dx[~valid] != 0).any()):
            fail(f"K3 {tag}: an ignored row has a non-zero CE or gradient")
        if bool((dx[:, vocab:] != 0).any()):
            fail(f"K3 {tag}: a -inf pad column has a non-zero gradient")
        err_b = check_close(f"dlogits {tag}", dx, want_dx, CE_GRAD_TOL[dtype])
        if dtype != torch.bfloat16 or width != padded:
            continue
        say(f"  ({int((~valid).sum())} of {rows} rows ignored, their CE and "
            "gradient exactly 0; the pad columns' gradient exactly 0)")
        elt = x.element_size()
        nbytes = rows * width * elt + rows * 8 + 2 * rows * 4
        # F.cross_entropy refuses labels >= V: those rows take its ignore label.
        lib_labels = labels.masked_fill(~valid, -1)
        xl = x.detach().requires_grad_()
        lib_ce = F.cross_entropy(xl, lib_labels, ignore_index=-1, reduction="none")

        def kernel():
            fused_masked_softmax_ce(x, labels)

        def plain():
            masked_softmax_ce_reference(x, labels)

        def library():
            F.cross_entropy(x, lib_labels, ignore_index=-1, reduction="none")

        def kernel_b():
            fused_masked_softmax_ce_bwd(x, labels, want_lse, cot)

        def plain_b():
            masked_softmax_ce_bwd_reference(x, labels, want_lse, cot)

        def library_b():
            torch.autograd.grad(lib_ce, xl, cot, retain_graph=True)

        for key, fns, nb, ops in (
                ("k3", (kernel, plain, library), nbytes, 5 * rows * width),
                ("k3b", (kernel_b, plain_b, library_b),
                 nbytes + rows * width * elt, 4 * rows * width)):
            ms = time_ms(fns[0], iters=10)
            plain_ms = time_ms(fns[1], iters=2, warmup=1)
            lib_ms = time_ms(fns[2], iters=10)
            bms, by = bound_ms(nb, ops, torch.float32)
            say(f"  time {'backward' if key == 'k3b' else 'forward'} {tag}: kernel "
                f"{ms:.4f} ms, plain twin {plain_ms:.4f} ms, F.cross_entropy"
                f"{' backward' if key == 'k3b' else ''} {lib_ms:.4f} ms, bound "
                f"{bms:.4f} ms ({by}: {nb / 1e6:.1f} MB)")
            out[key] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                        "bound_ms": bms, "bound_by": by,
                        "max_abs_err": err if key == "k3" else err_b}
        del lib_ce, xl
    return out


# -- phase 8: K4 ---------------------------------------------------------------------

def phase_k4(device, shapes) -> dict:
    """K4f and K4b against their twins on (B, H, S, D) views of a packed QKV
    projection; K4 against K1 on the same data; returns {"k4": timing,
    "k4b": timing} for bf16 without dropout."""
    say("K4 fused_attention on (B, H, S, D) (forward and backward) vs plain twins")
    g = torch.Generator(device=device).manual_seed(SEED + 5)
    b, h, d, s = shapes["batch"], shapes["heads"], shapes["head_dim"], shapes["seq"]
    out = {}

    def inputs(dtype):
        qkv, bias = attention_inputs(b, s, h, d, dtype, device, g)
        views = [t.unflatten(-1, (h, d)).transpose(1, 2) for t in qkv.split(h * d, dim=-1)]
        dout = torch.randn(b, s, h * d, generator=g, device=device).to(dtype)
        return qkv, bias, views, dout.unflatten(-1, (h, d)).transpose(1, 2)

    for dtype, rate in ((torch.bfloat16, 0.0), (torch.float32, 0.0),
                        (torch.bfloat16, 0.1), (torch.float32, 0.1)):
        seed = 4321 if rate > 0 else None
        qkv, bias, (q4, k4, v4), do4 = inputs(dtype)
        got, lse = fused_attention(q4, k4, v4, bias, seed, rate, need_lse=True)
        want, want_lse = fused_attention_reference(q4, k4, v4, bias, seed, rate, True)
        grads = fused_attention_bwd(q4, k4, v4, bias, do4, lse, seed, rate)
        wants = fused_attention_bwd_reference(q4, k4, v4, bias, do4, lse, seed, rate)
        packed = fused_attention_packed(*qkv.split(h * d, dim=-1), bias, h, seed, rate)
        sync()
        tag = f"B{b} S{s} H{h} D{d} {str(dtype)[6:]} rate {rate}"
        err = check_close(f"out {tag}", got, want, TOL[dtype])
        check_close(f"lse {tag}", lse, want_lse, TOL[torch.float32])
        err_b = max(check_close(f"{name} {tag}", x, y, GRAD_TOL[dtype])
                    for name, x, y in zip(("dq", "dk", "dv"), grads, wants))
        same = torch.equal(packed, got.transpose(1, 2).flatten(2))
        say(f"  K4 out == K1 out on the same data: {same}")
        if not same:
            fail(f"K4 and K1 disagree on the same data ({tag})")
        if dtype == torch.bfloat16:
            check_deterministic(f"K4b {tag}", lambda: fused_attention_bwd(
                q4, k4, v4, bias, do4, lse, seed, rate))
        if dtype != torch.bfloat16 or rate > 0:
            continue
        elt = qkv.element_size()
        n = 1 if REHEARSAL else copies_for_cold_l2(4 * b * s * h * d * elt)
        sets = [(q4, k4, v4, bias, do4, lse)]
        for _ in range(n - 1):
            _, kb_, (q_, k_, v_), do_ = inputs(dtype)
            sets.append((q_, k_, v_, kb_, do_,
                         fused_attention(q_, k_, v_, kb_, need_lse=True)[1]))
        it = iter(range(10 ** 9))

        def pick():
            return sets[next(it) % len(sets)]

        def kernel():
            fused_attention(*pick()[:4])

        def plain():
            fused_attention_reference(*pick()[:4])

        masks = [x[3].to(dtype)[:, None, None, :] for x in sets]

        def kernel_step():  # the S 768 train step's call: dropout and the lse
            fused_attention(*pick()[:4], 4321, 0.1, need_lse=True)

        def library():
            i = next(it) % len(sets)
            q_, k_, v_ = sets[i][:3]
            F.scaled_dot_product_attention(q_, k_, v_, attn_mask=masks[i])

        def kernel_b():
            fused_attention_bwd(*pick())

        def plain_b():
            fused_attention_bwd_reference(*pick())

        graphs = []
        for q_, k_, v_, kb_, do_, _ in sets:
            four = [t.detach().requires_grad_() for t in (q_, k_, v_)]
            o4 = F.scaled_dot_product_attention(*four, attn_mask=kb_.to(dtype)[:, None, None, :])
            graphs.append((o4, four, do_))

        def library_b():
            o4, four, do_ = graphs[next(it) % len(graphs)]
            torch.autograd.grad(o4, four, do_, retain_graph=True)

        io = b * s * h * d * elt
        for key, fns, nb, ops, e in (
                ("k4", (kernel, plain, library), 4 * io + b * s * 4,
                 4 * b * h * s * s * d, err),
                ("k4b", (kernel_b, plain_b, library_b),
                 7 * io + b * h * s * 4 + b * s * 4, 10 * b * h * s * s * d, err_b)):
            ms = time_ms(fns[0])
            plain_ms = time_ms(fns[1], iters=2, warmup=1)
            lib_ms = time_ms(fns[2])
            bms, by = bound_ms(nb, ops, dtype)
            bwd = key == "k4b"
            say(f"  time {'backward' if bwd else 'forward'} {tag}: kernel {ms:.4f} ms, "
                f"plain twin {plain_ms:.4f} ms, sdpa{' backward' if bwd else ''} "
                f"{lib_ms:.4f} ms, bound {bms:.4f} ms ({by}: {nb / 1e6:.1f} MB, "
                f"{ops / 1e9:.2f} GFLOP{'; the two kernels do ' + f'{1.8 * ops / 1e9:.2f}' if bwd else ''})")
            out[key] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                        "bound_ms": bms, "bound_by": by, "max_abs_err": e}
        out["k4"]["step_ms"] = time_ms(kernel_step)
        say(f"  time forward, the S {s} step's call (rate 0.1, lse): kernel "
            f"{out['k4']['step_ms']:.4f} ms")
        out["k4"].update(say_fwd_device_ms(f"forward {tag}", kernel, library, kernel_step))
        out["k4b"].update(say_bwd_device_ms(f"backward {tag}", kernel_b, library_b))
        del graphs

    # Head dim 128 (the same width in 6 heads): K4f and K4b against their twins.
    h2, d2 = h * d // 128, 128
    g2 = torch.Generator(device=device).manual_seed(SEED + 9)
    for rate in (0.0, 0.1):
        seed = 4321 if rate > 0 else None
        qkv, bias = attention_inputs(b, s, h2, d2, torch.bfloat16, device, g2)
        q4, k4, v4 = (t.unflatten(-1, (h2, d2)).transpose(1, 2)
                      for t in qkv.split(h2 * d2, dim=-1))
        do4 = torch.randn(b, s, h2, d2, generator=g2, device=device).to(
            torch.bfloat16).transpose(1, 2)
        got, lse = fused_attention(q4, k4, v4, bias, seed, rate, need_lse=True)
        want = fused_attention_reference(q4, k4, v4, bias, seed, rate)
        grads = fused_attention_bwd(q4, k4, v4, bias, do4, lse, seed, rate)
        wants = fused_attention_bwd_reference(q4, k4, v4, bias, do4, lse, seed, rate)
        sync()
        tag = f"B{b} S{s} H{h2} D{d2} bfloat16 rate {rate}"
        check_close(f"out {tag}", got, want, TOL[torch.bfloat16])
        for name, x, y in zip(("dq", "dk", "dv"), grads, wants):
            check_close(f"{name} {tag}", x, y, GRAD_TOL[torch.bfloat16])
        del grads, wants
    return out


# -- phase 9: K5 ---------------------------------------------------------------------

def flash_inputs(b, h, sq, sk, d, pad, dtype, device, g):
    """q (B, H, Q, D) and k, v (B, H, K, D) as views of packed projections (one
    for Q == K, two otherwise), a (B, K) key bias with the last ``pad`` keys
    masked, and an output cotangent."""
    proj = torch.randn(b, sq, 3 * h * d, generator=g, device=device).to(dtype)
    views = [t.unflatten(-1, (h, d)).transpose(1, 2) for t in proj.split(h * d, dim=-1)]
    if sk != sq:
        kv = torch.randn(b, sk, 3 * h * d, generator=g, device=device).to(dtype)
        views[1:] = [t.unflatten(-1, (h, d)).transpose(1, 2)
                     for t in kv.split(h * d, dim=-1)[1:]]
    bias = torch.zeros(b, sk, device=device)
    bias[:, sk - pad:] = -1e9
    dout = torch.randn(b, h, sq, d, generator=g, device=device).to(dtype)
    return (*views, bias, dout)


def phase_k5(device, shapes) -> dict:
    """K5f and K5b against their twins at the long-context shape, at a long
    S and with Q != K; K5f against K4f at the fused gate's top length;
    returns {"k5": timing, "k5b": timing} for bf16 at rate 0.1, the main
    path's setting (the backward runs K5b only at rate > 0)."""
    say("K5 flash_attention (forward and backward) vs plain twins")
    g = torch.Generator(device=device).manual_seed(SEED + 6)
    b, h0, d0, s, pad = (shapes[k] for k in ("batch", "heads", "head_dim", "seq", "pad"))
    h128 = h0 * d0 // 128  # the same width in heads of 128
    cases = [(b, s, s, h0, d0, dtype, rate) for dtype in (torch.bfloat16, torch.float32)
             for rate in (0.0, 0.1)]
    cases += [(b, s, s, h128, 128, torch.bfloat16, 0.1),
              (shapes["long_batch"], shapes["long_seq"], shapes["long_seq"], h0, d0,
               torch.bfloat16, 0.1),
              (b, shapes["cross"][0], shapes["cross"][1], h0, d0, torch.bfloat16, 0.1)]
    out = {}
    for bb, sq, sk, h, d, dtype, rate in cases:
        seed = 2468 if rate > 0 else None
        q, k, v, kb, dout = flash_inputs(bb, h, sq, sk, d, pad, dtype, device, g)
        got, lse = attn_ops._flash_forward(q, k, v, kb, seed, rate, need_lse=True)
        want, want_lse = flash_attention_reference(q, k, v, kb, seed, rate, True)
        grads = flash_attention_bwd(q, k, v, kb, got, dout, lse, seed, rate)
        wants = flash_attention_bwd_reference(q, k, v, kb, got, dout, lse, seed, rate)
        sync()
        tag = f"B{bb} Q{sq} K{sk} H{h} D{d} {str(dtype)[6:]} rate {rate}"
        err = check_close(f"out {tag}", got, want, TOL[dtype])
        check_close(f"lse {tag}", lse, want_lse, TOL[torch.float32])
        err_b = max(check_close(f"{name} {tag}", x, y, GRAD_TOL[dtype])
                    for name, x, y in zip(("dq", "dk", "dv"), grads, wants))
        del want, wants, grads
        if (bb, sq, sk, h, dtype, rate) != (b, s, s, h0, torch.bfloat16, 0.1):
            continue
        check_deterministic(f"K5b {tag}", lambda: flash_attention_bwd(
            q, k, v, kb, got, dout, lse, seed, rate))
        elt = q.element_size()
        io = bb * sq * h * d * elt
        n = 1 if REHEARSAL else copies_for_cold_l2(5 * io)
        sets = [(q, k, v, kb, dout, got, lse)]
        for _ in range(n - 1):
            q_, k_, v_, kb_, do_ = flash_inputs(bb, h, sq, sk, d, pad, dtype, device, g)
            sets.append((q_, k_, v_, kb_, do_,
                         *attn_ops._flash_forward(q_, k_, v_, kb_, seed, rate, True)))
        it = iter(range(10 ** 9))

        def pick():
            return sets[next(it) % len(sets)]

        def kernel():  # the train step's call: dropout and the lse
            attn_ops._flash_forward(*pick()[:4], seed, rate, need_lse=True)

        def kernel_eval():  # the eval call: no dropout, no lse
            flash_attention(*pick()[:4])

        def plain():
            flash_attention_reference(*pick()[:4], seed, rate, True)

        masks = [x[3].to(dtype)[:, None, None, :] for x in sets]

        def library():
            i = next(it) % len(sets)
            q_, k_, v_ = sets[i][:3]
            F.scaled_dot_product_attention(q_, k_, v_, attn_mask=masks[i])

        def kernel_b():
            q_, k_, v_, kb_, do_, o_, l_ = pick()
            flash_attention_bwd(q_, k_, v_, kb_, o_, do_, l_, seed, rate)

        def kernel_b0():  # rate 0, like for like with the SDPA backward
            q_, k_, v_, kb_, do_, o_, l_ = pick()
            flash_attention_bwd(q_, k_, v_, kb_, o_, do_, l_)

        def plain_b():
            q_, k_, v_, kb_, do_, o_, l_ = pick()
            flash_attention_bwd_reference(q_, k_, v_, kb_, o_, do_, l_, seed, rate)

        graphs = []
        for q_, k_, v_, kb_, do_, _, _ in sets:
            four = [t.detach().requires_grad_() for t in (q_, k_, v_)]
            o4 = F.scaled_dot_product_attention(
                *four, attn_mask=kb_.to(dtype)[:, None, None, :])
            graphs.append((o4, four, do_))

        def library_b():
            o4, four, do_ = graphs[next(it) % len(graphs)]
            torch.autograd.grad(o4, four, do_, retain_graph=True)

        eval_ms = time_ms(kernel_eval)
        rate0_ms = time_ms(kernel_b0)
        stats = bb * h * sq * 4
        fwd_ops = 4 * bb * h * sq * sk * d
        for key, fns, nb, ops, e in (
                ("k5", (kernel, plain, library), 4 * io + bb * sk * 4 + stats, fwd_ops, err),
                ("k5b", (kernel_b, plain_b, library_b), 8 * io + stats + bb * sk * 4,
                 10 * bb * h * sq * sk * d, err_b)):
            ms = time_ms(fns[0])
            plain_ms = time_ms(fns[1], iters=2, warmup=1)
            lib_ms = time_ms(fns[2])
            bms, by = bound_ms(nb, ops, dtype)
            bwd = key == "k5b"
            extra = (f"; the two kernels do {1.4 * ops / 1e9:.2f}, {1.4 * ops / ms / 1e9:.1f} "
                     f"TFLOP/s, and the time includes the di pre-pass; at rate 0, like "
                     f"for like with the sdpa backward: {rate0_ms:.4f} ms" if bwd else
                     f"; eval call (rate 0, no lse) {eval_ms:.4f} ms")
            say(f"  time {'backward' if bwd else 'forward'} {tag}: kernel {ms:.4f} ms, "
                f"plain twin {plain_ms:.4f} ms, sdpa{' backward' if bwd else ''} (rate 0) "
                f"{lib_ms:.4f} ms, bound {bms:.4f} ms ({by}: {nb / 1e6:.1f} MB, "
                f"{ops / 1e9:.2f} GFLOP{extra})")
            out[key] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                        "bound_ms": bms, "bound_by": by, "max_abs_err": e}
        out["k5"].update(say_fwd_device_ms(f"forward {tag[:-3]}0.0, eval call (no lse)",
                                           kernel_eval, library, kernel))
        out["k5b"]["rate0_ms"] = rate0_ms
        out["k5b"].update(say_bwd_device_ms(f"backward {tag}", kernel_b, library_b))
        rate0 = say_bwd_device_ms(f"backward {tag[:-3]}0.0", kernel_b0, library_b)
        out["k5b"]["rate0_device_ms"] = rate0.get("device_ms")
        del graphs, sets

    # K5f and K4f on the same data, at the fused gate's top length.  The TPU
    # kernels round at different running maxima and are not expected to
    # agree bit for bit; here both launch one device body (which rounds the
    # unnormalised probabilities for the PV product, as the TPU flash kernel
    # does), so they should.
    s4 = shapes["fused_seq"]
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, kb, _ = flash_inputs(b, h0, s4, s4, d0, pad, dtype, device, g)
        k5 = flash_attention(q, k, v, kb, 99, 0.1)
        k4 = fused_attention(q, k, v, kb, 99, 0.1)
        sync()
        check_close(f"K5f vs K4f B{b} S{s4} {str(dtype)[6:]} rate 0.1", k5, k4, TOL[dtype])
        say(f"  equal bit for bit: {torch.equal(k5, k4)}")
    return out


# -- phase 10: serving ------------------------------------------------------------

def build_world(sizes, device, dtype):
    world = SyntheticWorld(
        seed=3, num_scans=sizes["scans"], viewpoints_per_scan=sizes["viewpoints"],
        scene_feat_dim=sizes["feat"], dialog_turns=(2, 6), words_per_turn=(10, 30))
    table = SceneFeatureTable.pack(world.graphs, world.scene_features(), vfov=60)
    tok = WordPieceTokenizer(build_wordpiece_vocab(
        [" ".join(_WORDS), " ".join(_TARGETS)], vocab_size=4096))
    with tempfile.TemporaryDirectory() as d:
        root = world.write_task_data(d, counts={"val_unseen": sizes["instances"],
                                                "train": sizes["instances"]})
        instances, train_instances = (
            build_nav_instances(root, [split], tok, max_seq_length=sizes["seq"])
            for split in ("val_unseen", "train"))
    runtime = NavRuntime.build(world.graphs, table, device_dtype=dtype, device=device)
    return world, table, tok, instances, train_instances, runtime


def make_agent(sizes, tok, runtime, dtype, device, remat: bool = False, **agent_kw):
    cfg = BertConfig(vocab_size=len(tok), max_position_embeddings=sizes["seq"],
                     type_vocab_size=4, dtype=dtype, remat=remat, **sizes["bert"])
    return ViewpointAgent(cfg, runtime, feature_dim=sizes["feat"],
                          episode_len=sizes["episode_len"], rnn_dim=sizes["rnn"],
                          encoder_hidden_size=sizes["rnn"], device=device, **agent_kw)


def check_trajectories(results, instances, runtime, episode_len) -> None:
    by_idx = {it.inst_idx: it for it in instances}
    if set(results) != set(by_idx):
        fail(f"results cover {len(results)} of {len(by_idx)} instances")
    for idx, path in results.items():
        it = by_idx[idx]
        g = runtime.graphs[it.scan]
        row, view = runtime.start_state(it.scan, it.path("trusted_path")[0],
                                        it.start_pano["heading"], 0.0)
        start = (runtime.row_to_id(row)[1], geo.heading_of_view(view),
                 geo.elevation_of_view(view))
        if tuple(path[0]) != start:
            fail(f"instance {idx}: starts at {path[0]}, expected {start}")
        if not 1 <= len(path) <= episode_len + 1:
            fail(f"instance {idx}: {len(path)} poses for {episode_len} steps")
        for (a, _, _), (b, _, _) in zip(path, path[1:]):
            if not g.adjacency[g.index[a], g.index[b]]:
                fail(f"instance {idx}: step {a} -> {b} is not a graph edge")


def counted_run(agent, params, batcher, submit: bool):
    fused_attention_packed.launches = 0
    fused_add_layernorm.launches = 0
    sync()
    t0 = time.perf_counter()
    results = agent.test(params, batcher.eval_batches(), feedback="argmax",
                         submit=submit)
    sync()
    seconds = time.perf_counter() - t0
    return results, seconds, fused_attention_packed.launches, fused_add_layernorm.launches


def phase_serving(device, sizes) -> dict:
    say("serving: NDH argmax rollout, ViewpointAgent.test")
    t0 = time.perf_counter()
    world, table, tok, instances, train_instances, runtime = build_world(
        sizes, device, sizes["dtype"])
    agent = make_agent(sizes, tok, runtime, sizes["dtype"], device)
    params = agent.init_params(SEED)
    batcher = NavEpisodeBatcher(instances, runtime, batch_size=sizes["batch"])
    n_batches = -(-len(instances) // sizes["batch"])
    bucket = agent.trim_batch(next(iter(batcher.eval_batches())))["ids"].shape[1]
    lengths = [it.length for it in instances]
    say(f"  set-up {time.perf_counter() - t0:.1f} s: {len(instances)} instances "
        f"(dialogs {min(lengths)}-{max(lengths)} tokens, S bucket {bucket}), "
        f"{table.table.shape[0]} viewpoints, {n_batches} batches of {sizes['batch']}, "
        f"BERT {agent.cfg.num_hidden_layers}x{agent.cfg.hidden_size} {str(sizes['dtype'])[6:]}")

    agent.test(params, batcher.eval_batches(), feedback="argmax")  # warm-up
    if not REHEARSAL:
        torch.cuda.reset_peak_memory_stats()
    runs = {}
    for submit in (False, True):
        results, seconds, k1, k2 = counted_run(agent, params, batcher, submit)
        check_trajectories(results, instances, runtime, sizes["episode_len"])
        if not REHEARSAL:
            want1 = agent.cfg.num_hidden_layers * n_batches
            want2 = (2 * agent.cfg.num_hidden_layers + 1) * n_batches
            if (k1, k2) != (want1, want2):
                fail(f"kernel launches K1 {k1}, K2 {k2}; expected {want1}, {want2}")
        # Host-clock repeats: the rollout is partly bound by the host issuing
        # launches, so single readings spread; report the median and range.
        ms = sorted([seconds * 1e3 / n_batches]
                    + [counted_run(agent, params, batcher, submit)[1] * 1e3 / n_batches
                       for _ in range(4)])
        med = ms[len(ms) // 2]
        steps = np.mean([len(p) - 1 for p in results.values()])
        say(f"  submit={submit}: {len(results)} trajectories valid (mean {steps:.2f} "
            f"moves); launches K1 {k1}, K2 {k2}; {med:.2f} ms/batch (median of "
            f"{len(ms)} runs, range {ms[0]:.2f}-{ms[-1]:.2f}), "
            f"{sizes['batch'] / med * 1e3:.1f} episodes/s, "
            f"{sizes['batch'] * sizes['episode_len'] / med * 1e3:.1f} actions/s")
        runs[submit] = {"ms_per_batch": med, "k1": k1, "k2": k2, "results": results}
    peak = None if REHEARSAL else torch.cuda.max_memory_allocated()
    say(f"  peak device memory: {'n/a' if peak is None else f'{peak / 2**30:.2f} GiB'}")

    # Where the time goes in one batch of the device rollout.
    with torch.inference_mode():
        batch = agent.trim_batch(next(iter(batcher.eval_batches())))
        total = time_ms(lambda: agent.device_rollout(params, batch), iters=10, warmup=2)
        encode = time_ms(lambda: agent.encode(params, batch), iters=10, warmup=2)
        ids = agent._index(batch["ids"])
        lengths_t = agent._index(batch["lengths"])
        bert_params = {k[len("bert."):]: v for k, v in params["encoder"].items()
                       if k.startswith("bert.")}
        bert_kw = {"token_type_ids": agent._index(batch["segs"]),
                   "attention_mask": (torch.arange(ids.shape[1], device=ids.device)[None]
                                      < lengths_t[:, None]).int()}

        def bert_call():
            return functional_call(agent.encoder.bert, bert_params, (ids,), bert_kw)

        bert = time_ms(bert_call, iters=10, warmup=2)
        lstm_params = {n: params["encoder"][f"lstm.fwd.{n}"] for n in ("wi", "wh", "bi", "bh")}
        seq32 = bert_call()[0].float()
        lstm = time_ms(lambda: masked_lstm_scan(lstm_params, seq32, lengths_t), iters=10,
                       warmup=2)
    say(f"  time split of one batch (S {bucket}): device rollout {total:.2f} ms = "
        f"encode {encode:.2f} ms + {sizes['episode_len']} decode steps "
        f"{total - encode:.2f} ms; alone: BERT {bert:.2f} ms, masked LSTM "
        f"{lstm:.2f} ms (inside encode they overlap: the LSTM loop is bound by "
        f"the host issuing its launches); LSTM share {lstm / total:.1%}")
    if not REHEARSAL:
        profile_rollout(agent, params, batch)
    return {"bucket": bucket, "runs": runs, "peak_bytes": peak, "instances": instances,
            "train_instances": train_instances, "tok": tok, "world": world,
            "table": table, "agent": agent, "runtime": runtime}


def profile_rollout(agent, params, batch) -> None:
    """Device busy share of one device rollout and its top kernels."""
    with torch.inference_mode():
        profile_device(lambda: agent.device_rollout(params, batch), "device rollout")


def profile_device(fn, what: str, kinds: bool = False) -> float:
    """Run ``fn`` once warm, then once under torch.profiler (CUPTI); print
    nav_profile's summary of it (say_profile); return the idle share."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    summary = nav_profile.summarize(device_kernels(prof), 1, wall_s)
    say_profile(summary, f"one {what}", kinds)
    return summary["idle_share"]


def say_profile(prof: dict, what: str, kinds: bool = True) -> None:
    """Print a nav_profile summary: the device kernels, busy time and wall
    a step, the idle share, the top 8 kernels and (with ``kinds``) the busy
    time by kind of kernel."""
    say(f"  profile of {what}: {prof['kernels_per_step']:g} device kernels a step, busy "
        f"{prof['busy_ms_per_step']:.2f} ms of {prof['ms_per_step']:.2f} ms wall a step "
        f"(idle share {prof['idle_share']:.1%}; the wall includes the profiler's own cost)")
    for name, ms in list(prof["top_ops_ms_per_step"].items())[:8]:
        say(f"    {ms:8.3f} ms  {name[:90]}")
    if kinds:
        say("  busy time a step by kind: " + "; ".join(
            f"{kind} {ms:.3f} ms ({prof['groups_kernels_per_step'][kind]:g} kernels)"
            for kind, ms in prof["groups_ms_per_step"].items()))


def phase_agreement(device, sizes, sl) -> None:
    """fp32 on the card (kernels) against fp32 on the CPU (plain twins)."""
    say("agreement: fp32 card vs CPU on a 2-item batch")
    agents = {}
    for dev in (device, "cpu"):
        rt = NavRuntime.build(sl["world"].graphs, sl["table"], device_dtype=torch.float32,
                              device=dev)
        agents[dev] = make_agent(sizes, sl["tok"], rt, torch.float32, dev)
    batcher = NavEpisodeBatcher(sl["instances"][:2], agents[device].runtime, batch_size=2)
    batch = agents[device].trim_batch(next(iter(batcher.eval_batches())))
    out = {}
    with torch.inference_mode():
        for dev, agent in agents.items():
            params = agent.init_params(SEED)
            ctx, h0, c0, ctx_mask = agent.encode(params, batch)
            out[dev] = {"ctx": ctx, "h0": h0, "c0": c0, "params": params,
                        "ctx_mask": ctx_mask}
        ref = agents[device]
        rows, views, _, logits = ref.device_rollout(out[device]["params"], batch)
        # The CPU decoder follows the card's trajectory, so every step compares
        # the same decoder inputs.
        cpu = agents["cpu"]
        o = out["cpu"]
        h, c = o["h0"], o["c0"]
        cur_row = cpu._index(batch["start_rows"])
        view = cpu._index(batch["start_views"])
        cpu_logits = []
        for t in range(sizes["episode_len"]):
            logit, h, c = cpu.decode_step(o["params"], h, c, o["ctx"], o["ctx_mask"],
                                          cur_row, view)
            cpu_logits.append(logit)
            cur_row, view = rows[:, t].cpu(), views[:, t].cpu()
    for name in ("ctx", "h0", "c0"):
        check_close(name, out[device][name].cpu(), out["cpu"][name], AGREE_TOL)
    check_close(f"logits of {sizes['episode_len']} steps", logits.cpu(),
                torch.stack(cpu_logits, 1), AGREE_TOL)


# -- phase 11: train ----------------------------------------------------------------

# Every kernel wrapper, by the kernel's name in PERF.md.
COUNTED = {"K1f": fused_attention_packed, "K1b": fused_attention_packed_bwd,
           "K2f": fused_add_layernorm, "K2b": fused_add_layernorm_bwd,
           "K3f": fused_masked_softmax_ce, "K3b": fused_masked_softmax_ce_bwd,
           "K4f": fused_attention, "K4b": fused_attention_bwd,
           "K5f": flash_attention, "K5b": flash_attention_bwd}


def zero_counts() -> None:
    for fn in COUNTED.values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in COUNTED.items()}


def check_counts(per_step: dict, totals: dict, want: dict, n_steps: int) -> None:
    """Launches of every kernel in one step and in ``n_steps`` steps against
    ``want`` per step (kernels not named: 0)."""
    want = {name: want.get(name, 0) for name in COUNTED}
    say(f"  launches in one step: {', '.join(f'{k} {v}' for k, v in per_step.items())}; "
        f"in the {n_steps} timed steps: {', '.join(f'{k} {v}' for k, v in totals.items())}")
    if not REHEARSAL and (per_step != want
                          or totals != {k: n_steps * v for k, v in want.items()}):
        fail(f"kernel launches per step {per_step}, timed run {totals}; expected "
             f"{want} per step")


def phase_train(device, sizes, sl) -> dict:
    say("train: NDH teacher-forced train step, ViewpointAgent.train_step_fn")
    agent, runtime, cfg = sl["agent"], sl["runtime"], sl["agent"].cfg
    n_warm, n_timed = 2, 5
    t0 = time.perf_counter()
    batcher = NavEpisodeBatcher(sl["train_instances"], runtime, batch_size=sizes["batch"],
                                path_type="planner_path")
    batches = list(batcher.train_batches(n_warm + n_timed,
                                         episode_len=sizes["episode_len"]))
    buckets = [agent.trim_batch(b)["ids"].shape[1] for b in batches]
    step = agent.train_step_fn()
    say(f"  set-up {time.perf_counter() - t0:.1f} s: {len(sl['train_instances'])} train "
        f"instances, S buckets {buckets}, dropout hidden {cfg.hidden_dropout_prob} / "
        f"attention {cfg.attention_probs_dropout_prob} / agent {agent.dropout}, Adam lr "
        f"{agent.learning_rate}, clip {agent.max_grad_norm}")
    start, state, losses, ms, totals, peak = timed_steps(agent, step, agent.init_state,
                                                         batches, n_warm)
    med = check_trained(start, state, losses, ms, peak, sizes)
    time_split(agent, state, batches[n_warm])
    prof = None if REHEARSAL else profile_train_steps(step, state, batches[n_warm],
                                                      cfg.num_hidden_layers)
    bucket = max(set(buckets[n_warm:]), key=buckets[n_warm:].count)
    return {"ms_per_step": med, "range": (min(ms), max(ms)), "k1b": totals["K1b"],
            "k2b": totals["K2b"], "bucket": bucket, "peak_bytes": peak,
            "idle": None if prof is None else prof["idle_share"], "counts": totals,
            "profile": prof}


# Device kernels in one NDH train step at BERT-base, host-to-device copies
# left out: 14840 on two batches of bench.py's world.  The copies vary from
# step to step (4-7), so the earlier one-step profile's 14844 and 14845
# (PERF.md) held 4 and 5 of them.
NDH_STEP_COMPUTE_KERNELS = 14840
COPIES = "host-to-device copies"
# A port kernel's launch count in a profile: the device kernel each launch
# runs once (nav_profile.LAUNCH_KERNELS).
PROFILED_AS = {"K1f": "K1f/K4f/K5f", "K1b": "K1b/K4b/K5b", "K2f": "K2f", "K2b": "K2b"}


def profile_train_steps(step, state, batch, layers: int, steps: int = 3) -> dict:
    """tools/torch_profile_nav_step.py's summary (nav_profile.profile_steps)
    of ``steps`` train steps after one warm: printed by kind and top
    kernels; gated on the device kernels a step but the host-to-device
    copies (NDH_STEP_COMPUTE_KERNELS) and on K1f / K1b / K2f / K2b in the
    trace at the counted launches a step."""
    prof, _ = nav_profile.profile_steps(step, state, batch, steps=steps)
    say_profile(prof, f"{steps} train steps (tools/torch_profile_nav_step.py's summary)")
    copies = prof["groups_kernels_per_step"].get(COPIES, 0)
    compute = round((prof["kernels_per_step"] - copies) * steps)
    say(f"  device kernels in {steps} steps: {compute} and {round(copies * steps)} "
        "host-to-device copies")
    if compute != NDH_STEP_COMPUTE_KERNELS * steps:
        fail(f"{compute} device kernels but copies in {steps} profiled steps; expected "
             f"{NDH_STEP_COMPUTE_KERNELS} a step")
    want = ndh_launches(layers)
    seen = {k: prof["launches_per_step"][PROFILED_AS[k]] for k in want}
    say(f"  in the trace, a step: {', '.join(f'{k} {v:g}' for k, v in seen.items())}")
    if seen != want:
        fail(f"profiled launches a step {seen}; expected {want}")
    return prof


def timed_steps(agent, step, make_state, batches, n_warm: int):
    """Run ``step`` from ``make_state()`` over ``batches``: ``n_warm`` warm-up
    steps, then the rest one by one, each timed by the host clock around a
    sync, with every kernel's launches counted from 0 before the timed run
    and checked per step (an NDH step: K1f, K1b 1 a layer; K2f, K2b 2 a
    layer + 1).  The state is made here, so that no caller keeps the initial
    one alive through the run.  Returns (the initial parameters' copies, the
    final state, the steps' outputs, ms, launches of the timed run, peak
    device memory of the timed run)."""
    state = make_state()
    start = [t.clone() for t in tree_leaves(state["params"])]
    outs = []
    for batch in batches[:n_warm]:
        state, out = step(state, batch)
        outs.append(out)
    if not REHEARSAL:
        torch.cuda.reset_peak_memory_stats()
    zero_counts()
    per_step, ms = None, []
    for batch in batches[n_warm:]:
        sync()
        t1 = time.perf_counter()
        state, out = step(state, batch)
        sync()
        ms.append((time.perf_counter() - t1) * 1e3)
        outs.append(out)
        per_step = per_step or read_counts()
    totals = read_counts()
    peak = None if REHEARSAL else torch.cuda.max_memory_allocated()
    layers = agent.cfg.num_hidden_layers
    check_counts(per_step, totals, {"K1f": layers, "K1b": layers, "K2f": 2 * layers + 1,
                                    "K2b": 2 * layers + 1}, len(batches) - n_warm)
    return start, state, outs, ms, totals, peak


def check_trained(start, state, losses, ms, peak, sizes) -> float:
    """Losses finite, every parameter tensor but the BERT pooler's two
    changed and finite; print the losses, ms/step (median), nav actions/s
    (batch x episode_len a step, bench.py's count) and the peak memory;
    return the median ms/step."""
    losses = torch.stack(losses).float().cpu()
    if not torch.isfinite(losses).all():
        fail(f"non-finite train losses {losses.tolist()}")
    final = tree_leaves(state["params"])
    moved = sum(not torch.equal(a, b) for a, b in zip(start, final))
    if moved < len(final) - 2 or not all(torch.isfinite(p).all() for p in final):
        fail(f"{moved} of {len(final)} parameters changed, or some are not finite")
    med = sorted(ms)[len(ms) // 2]
    actions = sizes["batch"] * sizes["episode_len"]
    say(f"  losses {', '.join(f'{x:.4f}' for x in losses.tolist())}; {moved} of "
        f"{len(final)} parameter tensors changed (the BERT pooler takes no part)")
    say(f"  {med:.2f} ms/step (median of {len(ms)} steps, range {min(ms):.2f}-"
        f"{max(ms):.2f}), {actions / med * 1e3:.1f} nav actions/s; peak device "
        f"memory {'n/a' if peak is None else f'{peak / 2**30:.2f} GiB'}")
    return med


def time_split(agent, state, batch) -> None:
    """Where one step's time goes (CUDA events around each piece run alone):
    the whole forward, forward + backward and optimizer, and BERT, the
    masked LSTM and the decode half (projections excluded) each alone,
    forward and forward + backward.  The LSTM loop and the decode steps are
    bound by the host issuing launches, so inside the step the device runs
    BERT's kernels while the host is still issuing the LSTM's: the pieces
    alone add up to more than the step."""
    batch = agent.trim_batch(batch)
    params, rng = state["params"], state["rng"]
    live = {part: {n: p.detach().requires_grad_() for n, p in d.items()}
            for part, d in params.items()}
    timed = lambda fn: time_ms(fn, iters=3, warmup=1)  # noqa: E731
    fwd = timed(lambda: agent.episode_loss(live, batch, rng))
    total = timed(lambda: agent.loss_and_grads(params, batch, rng))
    _, grads = agent.loss_and_grads(params, batch, rng)
    opt = time_ms(lambda: apply_updates(params, agent.optimizer.update(
        grads, state["opt_state"], params)[0]), iters=5, warmup=1)
    ids, lengths = agent._index(batch["ids"]), agent._index(batch["lengths"])
    bert_params = {k[len("bert."):]: v for k, v in live["encoder"].items()
                   if k.startswith("bert.")}
    bert_kw = {"token_type_ids": agent._index(batch["segs"]), "rng": rng,
               "attention_mask": (torch.arange(ids.shape[1], device=ids.device)[None]
                                  < lengths[:, None]).int()}

    def bert():
        return functional_call(agent.encoder.bert, bert_params, (ids,), bert_kw)[0]

    seq = bert()
    cot = torch.randn_like(seq)
    lstm_params = {n: live["encoder"][f"lstm.fwd.{n}"] for n in ("wi", "wh", "bi", "bh")}
    seq32 = seq.detach().float().requires_grad_()

    def lstm():
        ys, (h, c) = masked_lstm_scan(lstm_params, seq32, lengths)
        return ys, h, c

    cots = [torch.randn_like(t) for t in lstm()]
    enc = [t.detach().requires_grad_() if t.is_floating_point() else t
           for t in agent.encode(params, batch)]
    dec_params = list(live["decoder"].values())

    def decode():
        return agent.teacher_forced_loss(live, batch, *enc, rng)

    parts = {
        "BERT": (bert, lambda: torch.autograd.grad(bert(), list(bert_params.values()),
                                                   cot, allow_unused=True)),
        "masked LSTM": (lstm, lambda: torch.autograd.grad(
            lstm(), [seq32, *lstm_params.values()], cots)),
        f"{agent.episode_len} decode steps + loss": (decode, lambda: torch.autograd.grad(
            decode(), [*enc[:3], *dec_params])),
    }
    alone = []
    for name, (f, fb) in parts.items():
        tf, tfb = timed(f), timed(fb)
        alone.append(f"{name} forward {tf:.2f} / backward {tfb - tf:.2f} ms")
    say(f"  time split of one step (S {ids.shape[1]}): forward {fwd:.2f} ms + backward "
        f"{total - fwd:.2f} ms + optimizer {opt:.2f} ms ({len(tree_leaves(params))} "
        f"tensors); alone: {'; '.join(alone)}")


def fp32_agents(device, sizes, sl, **agent_kw) -> dict:
    """{device: agent} on the card and on the CPU: fp32, every dropout 0."""
    agents = {}
    for dev in (device, "cpu"):
        rt = NavRuntime.build(sl["world"].graphs, sl["table"], device_dtype=torch.float32,
                              device=dev)
        cfg = BertConfig(vocab_size=len(sl["tok"]), max_position_embeddings=sizes["seq"],
                         type_vocab_size=4, dtype=torch.float32, hidden_dropout_prob=0.0,
                         attention_probs_dropout_prob=0.0, **sizes["bert"])
        agents[dev] = ViewpointAgent(cfg, rt, feature_dim=sizes["feat"],
                                     episode_len=sizes["episode_len"], rnn_dim=sizes["rnn"],
                                     encoder_hidden_size=sizes["rnn"], dropout=0.0,
                                     device=dev, **agent_kw)
    return agents


def phase_train_agreement(device, sizes, sl, path_type: str = "planner_path") -> None:
    """One fp32 train step with every dropout at 0 on a 2-item batch of
    ``sizes``' episodes: the card (kernels) against the CPU (plain twins)."""
    say(f"train agreement: one fp32 step ({sizes['episode_len']}-step {path_type} "
        "episodes), dropouts 0, card vs CPU on a 2-item batch")
    agents = fp32_agents(device, sizes, sl)
    batcher = NavEpisodeBatcher(sl["train_instances"][:2], agents["cpu"].runtime,
                                batch_size=2, path_type=path_type)
    batch = next(batcher.train_batches(1, episode_len=sizes["episode_len"]))
    out = {}
    for dev, agent in agents.items():
        state = agent.init_state()
        loss, grads = agent.loss_and_grads(state["params"], agent.trim_batch(batch), None)
        new, _ = agent.train_step_fn()(state, batch)
        out[dev] = step_record(loss, grads, state, new)
    check_step_agreement(device, out, agents["cpu"].learning_rate)


def step_record(loss, grads, state, new) -> tuple:
    """(loss, every gradient flat, every parameter's update flat) of one step."""
    return (loss, torch.cat([g.flatten() for g in tree_leaves(grads)]),
            torch.cat([(p1 - p0).flatten() for p1, p0 in
                       zip(tree_leaves(new["params"]), tree_leaves(state["params"]))]))


def check_step_agreement(device, out: dict, lr: float) -> None:
    """The card's step (``out[device]``, a :func:`step_record`) against the
    CPU's: loss and gradients within AGREE_TOL, the Adam update as below."""
    check_close("loss", out[device][0].cpu(), out["cpu"][0], AGREE_TOL)
    check_close("gradients", out[device][1].cpu(), out["cpu"][1], AGREE_TOL)
    # Adam's first step moves a parameter by lr * g / (|g| + eps): +-lr
    # wherever |g| is well above eps and above the gradients' disagreement,
    # so there the two updates agree to lr * 1e-2 and both move by > lr / 2.
    # Elsewhere each update is bounded by lr, their difference by 2 lr.
    step, want, g = out[device][2].cpu(), out["cpu"][2], out["cpu"][1]
    big = g.abs() > 10 * AGREE_TOL[0]
    diff = (step - want).abs()
    err = float(diff[big].max()) / lr
    say(f"  update of the Adam step ({int(big.sum())} of {g.numel()} "
        f"entries with |g| > {10 * AGREE_TOL[0]:g}): max|card - cpu| {err:.3g} lr "
        f"(tolerance 1e-2 lr there, 2 lr elsewhere); min moved "
        f"{float(step[big].abs().min()) / lr:.3g} lr (must exceed 0.5 lr)")
    if not big.any():
        fail("no gradient entry large enough to check the Adam update")
    if err > 1e-2 or float(diff.max()) > 2 * lr + 1e-6:
        fail(f"Adam update disagrees between {device} and the CPU")
    if float(step[big].abs().min()) <= 0.5 * lr or not torch.equal(
            step[big].sign(), -g[big].sign()):
        fail("the Adam step on the card did not move each parameter by ~lr against its gradient")


# -- phases 16-21: student-forced and RL fine-tuning, sampling, evaluation ---------------

STRATEGIES = ("argmax", "topk", "nucleus", "temperature", "penalty")


def phase_student(device, sizes, sl, rl: bool) -> dict:
    """The sampled (``rl`` False) or RL train step at phase 11's set-up:
    timed steps, launches, losses, parameters, the idle share; the sampled
    step also once with each other strategy."""
    agent, runtime = sl["agent"], sl["runtime"]
    name = "RL train: rl_train_step_fn" if rl else "sampled train: sample_train_step_fn('sample')"
    say(f"{name}, batch {sizes['batch']}, {sizes['episode_len']}-step episodes, planner_path")
    n_warm, n_timed = 2, 5
    batcher = NavEpisodeBatcher(sl["train_instances"], runtime, batch_size=sizes["batch"],
                                path_type="planner_path", seed=1 + rl)
    batches = [batcher.with_sample_teacher(b) for b in batcher.train_batches(n_warm + n_timed)]
    step = agent.rl_train_step_fn() if rl else agent.sample_train_step_fn("sample")
    start, state, outs, ms, totals, peak = timed_steps(
        agent, step, lambda: agent.init_state(with_critic=rl), batches, n_warm)
    med = check_trained(start, state, [o[0] if rl else o for o in outs], ms, peak, sizes)
    if rl:
        aux = {k: torch.stack([o[1][k] for o in outs]).float().cpu() for k in outs[0][1]}
        if not all(torch.isfinite(v).all() for v in aux.values()):
            fail(f"non-finite RL aux values {aux}")
        say("  aux of the last step: " + ", ".join(f"{k} {float(v[-1]):.4f}"
                                                   for k, v in aux.items()))
    idle = None if REHEARSAL else profile_device(
        lambda: step(state, batches[n_warm]), "RL step" if rl else "sampled step")
    if not rl:
        for feedback in STRATEGIES:
            _, loss = agent.sample_train_step_fn(feedback)(state, batches[n_warm])
            say(f"  one step with feedback {feedback}: loss {float(loss):.4f}")
            if not torch.isfinite(loss):
                fail(f"feedback {feedback}: non-finite loss")
    return {"ms_per_step": med, "range": (min(ms), max(ms)), "peak_bytes": peak,
            "idle": idle, "counts": totals, "state": state, "batch": batches[n_warm]}


def phase_no_sync(sl, rl_run) -> None:
    """The decode halves of a sampled step (every strategy) and of an RL
    step, from the encoder's outputs and the batch already on the card,
    under torch.cuda.set_sync_debug_mode("error"): any call that waits for
    the device raises."""
    say("no host sync: the sampled and RL decode loops under "
        "torch.cuda.set_sync_debug_mode('error')")
    agent, state = sl["agent"], rl_run["state"]
    batch = agent.trim_batch(rl_run["batch"])
    live = {part: {n: p.detach().requires_grad_() for n, p in d.items()}
            for part, d in state["params"].items()}
    rng, gen = state["rng"], state["sampler"]
    enc = agent.encode(live, batch, rng)
    d = agent.sample_inputs(batch)
    sync()
    if not REHEARSAL:
        torch.cuda.set_sync_debug_mode("error")
    try:
        losses = [agent.decode_sampled(live, d, *enc, rng, gen, feedback)
                  for feedback in ("sample",) + STRATEGIES]
        total, aux = agent.decode_rl(live, d, *enc, rng, gen)
    finally:
        if not REHEARSAL:
            torch.cuda.set_sync_debug_mode(0)
    got = torch.stack(losses + [total]).float().cpu()
    say(f"  {len(losses)} sampled decode loops and one RL loop of {agent.episode_len} "
        f"steps ran without a synchronising call; losses {got.tolist()}")
    if not torch.isfinite(got).all():
        fail("non-finite decode-loop losses")


@contextlib.contextmanager
def stand_in_sampler(noise: torch.Tensor):
    """decoding.categorical replaced by argmax(logit + one fixed noise
    table), on the card and on the CPU alike."""
    real = decoding.categorical
    decoding.categorical = lambda logit, generator=None: torch.argmax(
        logit + noise.to(logit.device), dim=-1)
    try:
        yield
    finally:
        decoding.categorical = real


def phase_student_agreement(device, sizes, sl) -> None:
    """fp32 with every dropout at 0 on a 2-item batch, the card (kernels)
    against the CPU (plain twins): the sampled loss and its gradients with
    argmax feedback; the RL loss, its aux values and gradients (critic
    included) under one stand-in sampler."""
    say("student agreement: fp32, dropouts 0, card vs CPU on a 2-item batch")
    agents = fp32_agents(device, sizes, sl)
    batcher = NavEpisodeBatcher(sl["train_instances"][:2], agents["cpu"].runtime,
                                batch_size=2, path_type="planner_path")
    batch = batcher.with_sample_teacher(next(batcher.train_batches(1)))
    k1 = agents["cpu"].runtime.max_candidates + 1
    noise = torch.from_numpy(np.random.default_rng(SEED).gumbel(size=(2, k1)).astype(
        np.float32))
    out = {}
    for dev, agent in agents.items():
        params = agent.init_params(SEED, with_critic=True)
        nav = {k: v for k, v in params.items() if k != "critic"}
        tb = agent.trim_batch(batch)
        loss, _, grads = agent.value_and_grads(nav, lambda p: (
            agent.sampled_episode_loss(p, tb, None, None, "argmax"), None))
        with stand_in_sampler(noise):
            rl_loss, aux, rl_grads = agent.value_and_grads(
                params, lambda p: agent.rl_episode_loss(p, tb, None, None))
        flat = lambda g: torch.cat([t.flatten() for t in tree_leaves(g)]).cpu()  # noqa: E731
        out[dev] = {"sampled loss (argmax)": loss.cpu(), "sampled gradients": flat(grads),
                    "RL loss": rl_loss.cpu(), **{f"RL {k}": v.cpu() for k, v in aux.items()},
                    "RL gradients (critic included)": flat(rl_grads)}
    for name, want in out["cpu"].items():
        check_close(name, out[device][name], want, AGREE_TOL)


# The distribution phase 20 holds select_action to: one row of logits
# (masked slots at -1e9), the taken slots of ``penalty`` and the temperature.
SAMPLE_LOGIT = np.array([0.3, -0.4, 1.1, 0.9, -1e9, 0.0, -1e9, -0.8], np.float32)
SAMPLE_TAKEN = np.array([False, True, True, False, False, False, False, False])
SAMPLE_TEMP = 0.7


def action_distribution(feedback: str) -> np.ndarray:
    """The probability of each slot in one draw of ``feedback`` on
    SAMPLE_LOGIT, from the JAX package's formulas
    (visitron_tpu/agents/decoding.py), in float64."""
    def softmax(x):
        e = np.exp(np.asarray(x, np.float64) - np.max(x))
        return e / e.sum()

    x = SAMPLE_LOGIT
    if feedback == "sample":
        return softmax(x)
    if feedback == "temperature":
        return softmax(x / SAMPLE_TEMP)
    if feedback == "penalty":
        return softmax(np.where(SAMPLE_TAKEN, x, x / SAMPLE_TEMP))
    if feedback == "topk":
        top = np.argsort(-x, kind="stable")[:3]
        p = np.zeros(len(x))
        p[top] = softmax(x[top])
        return p
    return 0.4 / len(x) + 0.6 * softmax(x)  # nucleus: masked slots included


def phase_sampling(device, draws: int) -> None:
    """select_action's draws on the card: each sampling strategy's slot
    frequencies over ``draws`` rows against its distribution (5 sigma a
    slot, exactly 0 where the probability is 0); argmax equal to the CPU's."""
    say(f"sampling: select_action on the card, {draws} draws a strategy")
    logit = torch.from_numpy(np.tile(SAMPLE_LOGIT, (draws, 1))).to(device)
    taken = torch.from_numpy(np.tile(SAMPLE_TAKEN, (draws, 1))).to(device)
    g = torch.Generator(device=device).manual_seed(SEED)
    for feedback in ("sample", "temperature", "penalty", "topk", "nucleus"):
        a = select_action(feedback, logit, g, temperature=SAMPLE_TEMP, taken_mask=taken)
        freq = np.bincount(a.cpu().numpy(), minlength=len(SAMPLE_LOGIT)) / draws
        want = action_distribution(feedback)
        sigma = np.sqrt(want * (1 - want) / draws)
        z = np.abs(freq - want)[want > 0] / sigma[want > 0]
        say(f"  {feedback}: frequencies {np.round(freq, 4).tolist()}, max |freq - p| "
            f"{z.max():.2f} sigma")
        if z.max() > 5 or (freq[want == 0] != 0).any():
            fail(f"{feedback}: frequencies {freq} disagree with {want}")
    x = torch.randn(4096, 16, generator=torch.Generator().manual_seed(SEED))
    x[:, 12:] = -1e9
    if not torch.equal(select_action("argmax", x.to(device)).cpu(), select_action("argmax", x)):
        fail("argmax on the card differs from the CPU's")
    say("  argmax on 4096 rows equals the CPU's")


def phase_evaluate(sl) -> None:
    """The serving run's argmax trajectories scored by the port's Evaluator
    (trusted_path, as the serving batches start)."""
    gt = [it.raw for it in sl["instances"] if it.raw.get("end_panos")]
    evaluator = Evaluator(gt, sl["world"].graphs, path_type="trusted_path")
    summary, _ = evaluator.score_results(
        {k: v for k, v in sl["runs"][False]["results"].items() if k in evaluator.instr_ids})
    say(f"evaluate: the argmax serving rollout of {len(gt)} episodes, "
        f"visitron_torch.evaluation.Evaluator: "
        + ", ".join(f"{k} {v:.4f}" for k, v in summary.items()))
    if not all(np.isfinite(v) for v in summary.values()):
        fail(f"non-finite evaluation summary {summary}")


# -- phases 41-42: bench.py's long NDH workload, NDH remat, bf16 Adam moments ------------------

def ndh_launches(layers: int, remat: bool = False, backward: bool = True) -> dict:
    """An NDH encoder pass's launches: K1f 1 a layer, K2f 2 a layer + 1 (the
    embedding LayerNorm), their backward kernels alike; ``remat`` runs each
    layer's forward again in the backward."""
    fwd = 2 if remat else 1
    out = {"K1f": fwd * layers, "K2f": fwd * 2 * layers + 1}
    if backward:
        out.update(K1b=layers, K2b=2 * layers + 1)
    return out


def check_launches(name: str, counts: dict, want: dict) -> None:
    want = {k: want.get(k, 0) for k in COUNTED}
    say(f"  {name}: launches {', '.join(f'{k} {v}' for k, v in counts.items() if v)}")
    if not REHEARSAL and counts != want:
        fail(f"{name}: launches {counts}; expected {want}")


def opt_state_bytes(opt_state) -> int:
    return sum(t.numel() * t.element_size() for t in parallel.mesh._leaves(opt_state)
               if isinstance(t, torch.Tensor))


def phase_t40(device, sizes, sl) -> dict:
    """41. NDH at bench.py's long workload (BENCH_EPISODE_LEN=40,
    BENCH_PATH_TYPE=trusted_path; tools/bench_eval.py's serving_t40) on
    phase 10's world at full width: (a) the teacher-forced step, 2 warm-up
    and 3 timed, launches a step as the 10-step episode's (the encoder runs
    once an episode), ms, nav actions/s, the idle share, peak memory; (b) the
    argmax serving rollout: trajectories on graph edges, launches and ms a
    batch, and the decode loop of one batch under
    torch.cuda.set_sync_debug_mode("error"); (c) one fp32 step with every
    dropout at 0 on a 2-item batch, card vs CPU; (d) the bf16 step's forward
    and backward with ``BertConfig(remat=True)`` against one without, from
    the same parameters, batch and dropout seeds: the loss equal bit for
    bit, the gradients within GRAD_TOL, the peak memory of both, and the
    remat step's ms."""
    t_len = sizes["long_episode_len"]
    long = {**sizes, "episode_len": t_len}
    layers = BertConfig(**sizes["bert"]).num_hidden_layers
    say(f"T {t_len}: NDH teacher-forced step, batch {sizes['batch']}, {t_len}-step "
        "trusted_path episodes (bench.py's BENCH_EPISODE_LEN=40 workload)")
    agent = make_agent(long, sl["tok"], sl["runtime"], sizes["dtype"], device)
    batcher = NavEpisodeBatcher(sl["train_instances"], sl["runtime"],
                                batch_size=sizes["batch"], path_type="trusted_path")
    n_warm, n_timed = 2, 3
    batches = list(batcher.train_batches(n_warm + n_timed, episode_len=t_len))
    active = np.mean([b["active"].sum(1).mean() for b in batches])
    step = agent.train_step_fn()
    start, state, losses, ms, totals, peak = timed_steps(agent, step, agent.init_state,
                                                         batches, n_warm)
    say(f"  mean active steps an episode {active:.2f} of {t_len}; S buckets "
        f"{[agent.trim_batch(b)['ids'].shape[1] for b in batches]}")
    med = check_trained(start, state, losses, ms, peak, long)
    del start
    idle = None if REHEARSAL else profile_device(
        lambda: step(state, batches[n_warm]), f"T {t_len} train step")
    train = {"ms_per_step": med, "range": (min(ms), max(ms)), "peak_bytes": peak,
             "idle": idle, "actions_per_s": sizes["batch"] * t_len / med * 1e3,
             "launches": {k: v // n_timed for k, v in totals.items()}}

    say(f"T {t_len}: the argmax serving rollout, ViewpointAgent.test (serving_t{t_len})")
    params = state["params"]
    eval_batcher = NavEpisodeBatcher(sl["instances"], sl["runtime"],
                                     batch_size=sizes["batch"])
    n_batches = -(-len(sl["instances"]) // sizes["batch"])
    agent.test(params, eval_batcher.eval_batches(), feedback="argmax")  # warm-up
    zero_counts()
    results, seconds, _, _ = counted_run(agent, params, eval_batcher, submit=False)
    serve_counts = {k: v // n_batches for k, v in read_counts().items()}
    check_trajectories(results, sl["instances"], sl["runtime"], t_len)
    check_launches(f"serving at T {t_len}, a batch", serve_counts,
                   ndh_launches(layers, backward=False))
    runs = sorted([seconds * 1e3 / n_batches]
                  + [counted_run(agent, params, eval_batcher, False)[1] * 1e3 / n_batches
                     for _ in range(4)])
    serve_ms = runs[len(runs) // 2]
    moves = np.mean([len(p) - 1 for p in results.values()])
    say(f"  {len(results)} trajectories on graph edges (mean {moves:.2f} moves); "
        f"{serve_ms:.2f} ms/batch (median of {len(runs)} runs, range {runs[0]:.2f}-"
        f"{runs[-1]:.2f}), {sizes['batch'] / serve_ms * 1e3:.1f} episodes/s, "
        f"{sizes['batch'] * t_len / serve_ms * 1e3:.1f} actions/s")
    with torch.inference_mode():
        batch = agent.trim_batch(next(iter(eval_batcher.eval_batches())))
        enc = agent.encode(params, batch)
        rows, views = agent._index(batch["start_rows"]), agent._index(batch["start_views"])
        sync()
        if not REHEARSAL:
            torch.cuda.set_sync_debug_mode("error")
        try:
            out = agent.decode_rollout(params, *enc, rows, views)
        finally:
            if not REHEARSAL:
                torch.cuda.set_sync_debug_mode(0)
    say(f"  the {t_len}-step argmax decode loop of one batch ran without a "
        f"synchronising call; logits {tuple(out[3].shape)}")
    if not torch.isfinite(out[3].float().masked_fill(out[3] < -1e8, 0)).all():
        fail(f"non-finite T {t_len} rollout logits")
    del out, enc
    serving = {"ms_per_batch": serve_ms, "launches": serve_counts,
               "episodes_per_s": sizes["batch"] / serve_ms * 1e3}

    phase_train_agreement(device, long, sl, path_type="trusted_path")

    say(f"T {t_len}: remat, one forward and backward with BertConfig(remat=True) and one "
        "without, same parameters, batch and dropout seeds")
    remat_agent = make_agent(long, sl["tok"], sl["runtime"], sizes["dtype"], device,
                             remat=True)
    batch = agent.trim_batch(batches[n_warm])
    grads_of, remat = {}, {}
    for name, ag in (("plain", agent), ("remat", remat_agent)):
        sync()
        if not REHEARSAL:
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t1 = time.perf_counter()
        loss, grads = ag.loss_and_grads(params, batch, ag.dropout_rng())
        sync()
        seconds = time.perf_counter() - t1
        counts = read_counts()
        rise = None if REHEARSAL else torch.cuda.max_memory_allocated() - base
        grads_of[name] = (loss, torch.cat([g.flatten() for g in tree_leaves(grads)]).cpu())
        del grads
        say(f"  {name}: loss {float(loss):.6f}, {seconds * 1e3:.1f} ms (host clock, one "
            f"run), peak device memory above the resident state "
            f"{'n/a' if rise is None else f'{rise / 2**30:.2f} GiB'}")
        check_launches(f"{name} forward and backward", counts,
                       ndh_launches(layers, remat=name == "remat"))
        remat[f"{name}_peak_rise_bytes"] = rise
        remat[f"{name}_launches"] = counts
    (l0, g0), (l1, g1) = grads_of["plain"], grads_of["remat"]
    say(f"  losses equal bit for bit: {bool(torch.equal(l0, l1))}")
    if not torch.equal(l0, l1):
        fail("the remat step's loss differs from the plain step's")
    check_close(f"remat gradients vs plain ({g0.numel()} entries)", g1, g0,
                GRAD_TOL[sizes["dtype"]])
    del grads_of, g0, g1
    rstep = remat_agent.train_step_fn()
    rstate = {**state, "rng": remat_agent.dropout_rng()}
    rms = []
    for b in batches[n_warm:n_warm + 3]:
        sync()
        t1 = time.perf_counter()
        rstate, rloss = rstep(rstate, b)
        sync()
        rms.append((time.perf_counter() - t1) * 1e3)
    remat["ms_per_step"] = sorted(rms)[len(rms) // 2]
    say(f"  remat step {remat['ms_per_step']:.2f} ms (median of {len(rms)}) beside the plain "
        f"step's {med:.2f} ms; loss {float(rloss):.4f}")
    if not torch.isfinite(rloss):
        fail("non-finite remat step loss")
    del rstate, state, remat_agent, agent
    release()
    return {"train": train, "serving": serving, "remat": remat}


def phase_bf16_moments(device, sizes, sl) -> dict:
    """42. ``bf16_adam_moments`` (bench.py's BENCH_BF16_ADAM): the NDH
    teacher-forced step at phase 11's set-up, two steps: launches, finite
    losses, the moments bf16 and the optimizer state half the bytes of the
    same parameters' fp32-moment state; then two fp32 steps with every
    dropout at 0 on a 2-item batch, card vs CPU: the parameters within
    lr * 1e-2 wherever both steps' gradients exceed 10 x AGREE_TOL (2 lr a
    step elsewhere)."""
    say(f"bf16 Adam moments: NDH teacher-forced step with bf16_adam_moments, batch "
        f"{sizes['batch']}, {sizes['episode_len']}-step planner_path episodes, 2 steps")
    layers = BertConfig(**sizes["bert"]).num_hidden_layers
    agent = make_agent(sizes, sl["tok"], sl["runtime"], sizes["dtype"], device,
                       bf16_adam_moments=True)
    batcher = NavEpisodeBatcher(sl["train_instances"], sl["runtime"],
                                batch_size=sizes["batch"], path_type="planner_path", seed=4)
    step = agent.train_step_fn()
    state = agent.init_state()
    ms, losses = [], []
    zero_counts()
    for batch in batcher.train_batches(2, episode_len=sizes["episode_len"]):
        sync()
        t1 = time.perf_counter()
        state, loss = step(state, batch)
        sync()
        ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(loss))
    counts = {k: v // 2 for k, v in read_counts().items()}
    check_launches("a step", counts, ndh_launches(layers))
    adam = state["opt_state"][1]
    dtypes = {str(t.dtype) for name in ("mu", "nu") for t in tree_leaves(adam[name])}
    low = opt_state_bytes(state["opt_state"])
    full = opt_state_bytes(agent_optimizer(agent.learning_rate, "adam", agent.max_grad_norm)
                           .init(state["params"]))
    say(f"  losses {losses}; ms a step {', '.join(f'{x:.2f}' for x in ms)} (the first "
        f"with warm-up); moments {sorted(dtypes)}; optimizer state {low / 2**20:.2f} MiB "
        f"with bf16 moments, {full / 2**20:.2f} MiB with fp32 ({low / full:.4f}x)")
    if not np.isfinite(losses).all():
        fail(f"non-finite bf16-moment losses {losses}")
    if dtypes != {"torch.bfloat16"} or 2 * low != full:
        fail(f"moments {dtypes}, {low} state bytes against {full} with fp32 moments")
    del state, agent
    release()

    say("bf16 Adam moments agreement: two fp32 steps, dropouts 0, card vs CPU on a 2-item "
        "batch")
    agents = fp32_agents(device, sizes, sl, bf16_adam_moments=True)
    batches = list(NavEpisodeBatcher(sl["train_instances"][:2], agents["cpu"].runtime,
                                     batch_size=2, path_type="planner_path")
                   .train_batches(2, episode_len=sizes["episode_len"]))
    ends, big = {}, None
    for dev, ag in agents.items():
        state = ag.init_state()
        start = torch.cat([p.detach().flatten().cpu() for p in tree_leaves(state["params"])])
        for b in batches:
            if dev == device:  # the gradients that decide where Adam's step is sign-like
                g = torch.cat([x.flatten() for x in tree_leaves(
                    ag.loss_and_grads(state["params"], ag.trim_batch(b), None)[1])]).cpu()
                mask = g.abs() > 10 * AGREE_TOL[0]
                big = mask if big is None else big & mask
            state, _ = ag.train_step_fn()(state, b)
        adam = state["opt_state"][1]
        if {t.dtype for n in ("mu", "nu") for t in tree_leaves(adam[n])} != {torch.bfloat16}:
            fail(f"{dev}: the moments are not bf16")
        ends[dev] = torch.cat([p.detach().flatten().cpu() for p in tree_leaves(
            state["params"])]) - start
    lr = agents["cpu"].learning_rate
    diff = (ends[device] - ends["cpu"]).abs()
    err = float(diff[big].max()) / lr if big.any() else float("nan")
    say(f"  parameters after two steps ({int(big.sum())} of {diff.numel()} entries with "
        f"|g| > {10 * AGREE_TOL[0]:g} in both steps): max|card - cpu| {err:.3g} lr "
        f"(tolerance 1e-2 lr there), {float(diff.max()) / lr:.3g} lr elsewhere (tolerance 4 lr)")
    if not big.any() or err > 1e-2 or float(diff.max()) > 4 * lr + 1e-6:
        fail("the bf16-moment steps disagree between the card and the CPU")
    return {"ms": ms, "launches": counts, "state_bytes": low, "fp32_state_bytes": full,
            "agree_lr": err}


# -- phases 43-44: the deployment's world on the card, and learning end to end -----------

def rss_gib() -> dict:
    """The host's resident memory now (VmRSS) and getrusage's peak, in GiB."""
    out = {"peak_rss_gib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20}
    with open("/proc/self/status") as f:
        for line in f:
            key, _, value = line.partition(":")
            if key == "VmRSS":
                out["rss_gib"] = int(value.split()[0]) / 2 ** 20
    return out


def gather_device_ms(tag: str, runtime, batch) -> dict:
    """Device time of the decoder's table reads over one teacher-forced
    episode of ``batch``: gather_step_inputs at each of its T steps, at the
    rows and views the steps read (torch.profiler, mean of 5 passes); the
    index / gather kernels, and every kernel of the calls."""
    if REHEARSAL:
        return {}
    rows = torch.as_tensor(np.asarray(batch["cur_row"]), dtype=torch.int64).to(runtime.device)
    views = torch.as_tensor(np.asarray(batch["view"]), dtype=torch.int64).to(runtime.device)

    def episode():
        with torch.inference_mode():
            for t in range(rows.shape[1]):
                gather_step_inputs(runtime, rows[:, t], views[:, t])

    by_name = device_ms(episode)
    if by_name is None:
        return not_measured(f"the gathers, {tag}", "gathers_ms", "all_ms")
    gathers = {n: ms for n, ms in by_name.items() if "index" in n.lower()
               or "gather" in n.lower()}
    out = {"gathers_ms": sum(gathers.values()), "all_ms": sum(by_name.values())}
    say(f"  device time of one episode's table reads ({tag}, {rows.shape[1]} steps of "
        f"{rows.shape[0]} rows; torch.profiler, mean of 5): index/gather kernels "
        f"{out['gathers_ms']:.4f} ms ({len(gathers)} kinds), all of gather_step_inputs' "
        f"kernels {out['all_ms']:.4f} ms")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        say(f"    {ms:8.4f} ms  {name[:100]}")
    return out


def phase_realscale(device, rs, sizes, sl) -> dict:
    """43. The deployment's world on the card (tools/realscale_smoke.py's
    configuration, visitron_torch.testing.realscale): (a) the world of 90
    scans x 120 viewpoints, its bf16 scene table packed on the host into
    page-locked memory and placed with one copy (1,592,524,800 bytes), then
    two teacher-forced steps at T 10 planner_path and at T 40 trusted_path
    (batch 64, BERT-base bf16): finite losses, launches a step as the small
    world's; (b) the argmax serving rollout at T 10 on this runtime:
    trajectories on graph edges, launches a batch, the decode loop under
    torch.cuda.set_sync_debug_mode("error"); (c) the host seconds of the
    world, the pack, the candidate tables and the placement, the host's
    memory, the table's bytes on the card, the card's memory after
    placement and its peak over the steps, the T 10 step's ms (median of 5
    after 2 warm-up) and the device time of one episode's table reads, on
    this runtime and on phase 10's 240-viewpoint runtime."""
    layers = BertConfig(**rs["bert"]).num_hidden_layers
    say(f"realscale: the deployment's world resident on the "
        f"{'CPU' if REHEARSAL else 'card'} (tools/realscale_smoke.py's configuration)")
    before = rss_gib()
    mem0 = 0 if REHEARSAL else torch.cuda.memory_allocated()
    rw = realscale.build_world(device, **rs["world"])
    host = rss_gib()
    table, feats = rw.table.table, rw.runtime.feats
    placed = 0 if REHEARSAL else torch.cuda.memory_allocated() - mem0
    want_bytes = table.shape[0] * geo.NUM_VIEWS * rw.world.scene_feat_dim * 2
    card_bytes = feats.numel() * feats.element_size()
    say(f"  {table.shape[0]} viewpoints ({len(rw.world.graphs)} scans); host seconds: "
        + ", ".join(f"{k} {v:.2f}" for k, v in rw.seconds.items())
        + f"; host table {str(table.dtype)[6:]}, page-locked {table.is_pinned()}; on the "
        f"{feats.device.type}: {card_bytes} bytes {str(feats.dtype)[6:]} (expected "
        f"{want_bytes}); the card's memory {placed / 2 ** 30:.3f} GiB placed")
    say(f"  host memory: resident {before['rss_gib']:.2f} -> {host['rss_gib']:.2f} GiB, "
        f"peak (getrusage) {before['peak_rss_gib']:.2f} -> {host['peak_rss_gib']:.2f} GiB")
    if (table.dtype != torch.bfloat16 or feats.dtype != torch.bfloat16
            or card_bytes != want_bytes or (not REHEARSAL and not table.is_pinned())):
        fail(f"the scene table: host {table.dtype}, pinned {table.is_pinned()}, device "
             f"{feats.dtype}, {card_bytes} bytes against {want_bytes}")
    if not REHEARSAL and rs["world"] == {} and card_bytes != 1_592_524_800:
        fail(f"the Matterport-scale table holds {card_bytes} bytes, not 1,592,524,800")
    inst, tok = realscale.instances(rw, n=rs["instances"], seq=rs["seq"])

    def agent_for(t_len):
        return realscale.make_agent(rw, tok, t_len, seq=rs["seq"], dtype=rs["dtype"],
                                    bert=rs["bert"], **rs["agent"])

    out = {"viewpoints": int(table.shape[0]), "table_bytes": int(card_bytes),
           "placed_bytes": int(placed), "host_seconds": rw.seconds,
           "host_rss_gib": {"before": before, "after": host}, "launches": {}, "losses": {}}
    reset_peak()
    trained = None
    for path_type, t_len in realscale.SHAPES:
        agent = agent_for(t_len)
        batch = realscale.first_batch(rw, inst, path_type, t_len, batch_size=rs["batch"])
        zero_counts()
        t0 = time.perf_counter()
        state, losses = realscale.train_steps(agent, batch, 2)
        losses = [float(x) for x in losses]
        seconds = time.perf_counter() - t0
        counts = {k: v // 2 for k, v in read_counts().items()}
        say(f"  T {t_len} {path_type}, batch {rs['batch']}: losses {losses}, the two steps "
            f"{seconds:.1f} s (the first with warm-up); peak so far {peak_gib():.2f} GiB")
        if not np.isfinite(losses).all():
            fail(f"non-finite losses at T {t_len} on the Matterport-scale world")
        check_launches(f"T {t_len} step", counts, ndh_launches(layers))
        if not REHEARSAL and read_counts() != {k: 2 * v for k, v in counts.items()}:
            fail("the two steps launched different kernels")
        out["launches"][f"t{t_len}_step"] = counts
        out["losses"][f"t{t_len}"] = losses
        if t_len == 10:
            trained = (agent, state["params"])
        del state
    out["peak_gib"] = peak_gib()

    say(f"realscale: the argmax serving rollout at T 10 on the "
        f"{table.shape[0]}-viewpoint runtime")
    agent, params = trained
    eval_batcher = NavEpisodeBatcher(inst, rw.runtime, batch_size=rs["batch"])
    n_batches = -(-len(inst) // rs["batch"])
    agent.test(params, eval_batcher.eval_batches(), feedback="argmax")  # warm-up
    zero_counts()
    results, seconds, _, _ = counted_run(agent, params, eval_batcher, submit=False)
    serve_counts = {k: v // n_batches for k, v in read_counts().items()}
    check_trajectories(results, inst, rw.runtime, 10)
    check_launches("serving, a batch", serve_counts, ndh_launches(layers, backward=False))
    moves = np.mean([len(p) - 1 for p in results.values()])
    say(f"  {len(results)} trajectories on graph edges (mean {moves:.2f} moves); "
        f"{seconds * 1e3 / n_batches:.2f} ms/batch (one run)")
    with torch.inference_mode():
        batch = agent.trim_batch(next(iter(eval_batcher.eval_batches())))
        enc = agent.encode(params, batch)
        rows, views = agent._index(batch["start_rows"]), agent._index(batch["start_views"])
        sync()
        if not REHEARSAL:
            torch.cuda.set_sync_debug_mode("error")
        try:
            rolled = agent.decode_rollout(params, *enc, rows, views)
        finally:
            if not REHEARSAL:
                torch.cuda.set_sync_debug_mode(0)
    say("  the 10-step argmax decode loop of one batch ran without a synchronising call")
    if not torch.isfinite(rolled[3].float().masked_fill(rolled[3] < -1e8, 0)).all():
        fail("non-finite rollout logits on the Matterport-scale world")
    out["launches"]["serving_batch"] = serve_counts
    out["serving"] = {"trajectories": len(results), "mean_moves": float(moves),
                      "ms_per_batch": seconds * 1e3 / n_batches}
    del trained, agent, params, enc, rolled

    say(f"realscale: the T 10 step ({rs['timed']} timed after 2 warm-up) and one episode's "
        f"table reads, on this world and on phase 10's {sl['table'].table.shape[0]}-viewpoint "
        "world, in this call")
    out["t10_step_ms"], out["gathers"] = {}, {}
    worlds = (("realscale", rw.runtime, inst, agent_for(10)),
              ("bench", sl["runtime"], sl["train_instances"],
               make_agent(sizes, sl["tok"], sl["runtime"], sizes["dtype"], device)))
    for name, runtime, instances, agent in worlds:
        batches = list(NavEpisodeBatcher(instances, runtime, batch_size=rs["batch"],
                                         path_type="planner_path")
                       .train_batches(2 + rs["timed"], episode_len=10))
        n_rows = runtime.feats.shape[0]
        say(f"  {name}: {n_rows} viewpoints, table {n_rows * runtime.feats[0].nbytes / 1e6:.1f}"
            " MB")
        start, state, losses, ms, _, peak = timed_steps(agent, agent.train_step_fn(),
                                                        agent.init_state, batches, 2)
        med = check_trained(start, state, losses, ms, peak,
                            {"batch": rs["batch"], "episode_len": 10})
        out["t10_step_ms"][name] = {"median": med, "range": (min(ms), max(ms))}
        out["gathers"][name] = gather_device_ms(name, runtime, batches[2])
        del agent, start, state
    del worlds, rw, table, feats
    release()
    return out


def phase_science(device, sci) -> dict:
    """44. The science run (tools/synthetic_e2e.py's, through
    visitron_torch.testing.science): BERT-base bf16, T 10 planner_path,
    batch 32, Adam 1e-4 on the seed-5 world of 4 scans x 50 viewpoints,
    ``iters`` steps between two argmax evaluations of the first 48 training
    episodes by Evaluator.  Gates: every loss finite, launches a step as an
    NDH step's, the mean loss of the last 50 steps <= 0.6 x that of the
    first 50, GP after - GP before >= 1.0 m, SR after > SR before (reported,
    not enforced, in a rehearsal); nav actions/s over the training loop."""
    iters, window = sci["iters"], min(50, sci["iters"] // 2)
    say(f"science: train -> argmax rollout -> Evaluator, batch {sci['batch']}, T 10 "
        f"planner_path, {iters} iterations (tools/synthetic_e2e.py's run)")
    sc = science.setup(batch=sci["batch"], episodes=sci["episodes"], seq=sci["seq"],
                       device=device, dtype=sci["dtype"], world=sci["world"],
                       bert=sci["bert"], **sci["agent"])
    layers = sc.agent.cfg.num_hidden_layers
    state = sc.agent.init_state()
    before = science.brief(science.evaluate(sc, state["params"]))
    zero_counts()
    state, losses, seconds = science.train(sc, state, iters, log=say)
    counts = read_counts()
    after = science.brief(science.evaluate(sc, state["params"]))
    del state
    per_step = {k: v // iters for k, v in counts.items()}
    check_launches("a step", per_step, ndh_launches(layers))
    if not REHEARSAL and counts != {k: iters * v for k, v in per_step.items()}:
        fail(f"launches over {iters} steps {counts}")
    first, last = float(np.mean(losses[:window])), float(np.mean(losses[-window:]))
    actions = sci["batch"] * 10 * iters / seconds
    out = {"before": before, "after": after, "loss_first": first, "loss_last": last,
           "window": window, "iters": iters, "seconds": seconds, "actions_per_s": actions,
           "launches": per_step}
    say("  before: " + ", ".join(f"{k} {v:.3f}" for k, v in before.items())
        + "; after: " + ", ".join(f"{k} {v:.3f}" for k, v in after.items()))
    say(f"  mean loss of the first {window} steps {first:.4f}, of the last {window} "
        f"{last:.4f} (ratio {last / first:.3f}); {seconds:.1f} s of training, "
        f"{actions:.1f} nav actions/s")
    if not np.isfinite(losses).all():
        fail("non-finite losses in the science run")
    gates = {"loss ratio <= 0.6": last <= 0.6 * first,
             "GP gain >= 1.0 m": after["gp"] - before["gp"] >= 1.0,
             "SR after > SR before": after["sr"] > before["sr"]}
    say("  gates: " + ", ".join(f"{k} {'met' if v else 'MISSED'}" for k, v in gates.items())
        + (" (reported, not enforced, at the rehearsal's size)" if REHEARSAL else ""))
    if not REHEARSAL and not all(gates.values()):
        fail(f"the science run missed {[k for k, v in gates.items() if not v]}")
    out["gates"] = gates
    del sc
    release()
    return out


# -- phase 45: the back-translation A/B -------------------------------------------------

# Gates fixed in PERF.md before the phase's first run at these settings on
# the card: the weaker of the JAX tool's and the port's tool's CPU runs at
# the phase's settings and seed 88 (speaker word CE last / first log 0.504 /
# 0.476, parse 1.0 / 1.0, hop_acc 0.495 / 0.541, hop_acc over the control's
# 0.253 / 0.307, loss ratios 0.786 and 0.812 / 0.751 and 0.801), with a
# margin of 0.15 (0.10 on the loss ratios, means of 50 steps, and over the
# control, which a speaker that reads only the walk's length beats by
# 0.10; the CE a log is one batch's).
AUG_AB_GATES = {"speaker_ce_ratio": 0.654, "parse": 0.85, "hop_acc": 0.345,
                "over_control": 0.153, "loss_ratio": 0.912}


def follower_launches(cfg, seq: int, backward: bool = True) -> dict:
    """An encoder pass's launches (ndh_launches) at ``cfg``'s head dim: K1
    only where the fused gate takes it (the A/B's 128 / 4 heads = 32 does
    not, so its attention is the plain one, as in the JAX package)."""
    want = ndh_launches(cfg.num_hidden_layers, backward=backward)
    if not attention_supports_fused(seq, seq, cfg.hidden_size // cfg.num_attention_heads):
        for k in ("K1f", "K1b"):
            want.pop(k, None)
    return want


def phase_aug_ab(device, ab) -> dict:
    """45. The back-translation A/B (tools/aug_ab.py's, through
    visitron_torch.testing.aug_ab) at a cut budget: the tool's world, widths
    and seed 88, the speaker with the pipeline's feature dropout 0.6 and
    movement frame, ``n_aug`` records, arms baseline and aug.  Gates: records
    == instances == n_aug, every record's path a walk over graph edges, no
    K1-K5 launch in the speaker's steps or the augment, the follower's
    launches a step as counted from the code and none of a backward kernel
    in its evaluation; the speaker's word CE at its last log over its first,
    the captions' parse and hop accuracy, each arm's loss ratio (last 50 /
    first 50) against AUG_AB_GATES (reported, not enforced, in a rehearsal).
    ΔGP is printed, not gated: its sign flips between seeds."""
    counts = {}

    def stage(name):
        counts[name] = read_counts()
        zero_counts()

    say(f"aug_ab: speaker {ab['speaker_iters']} iterations -> {ab['n_aug']} captioned "
        f"walks -> follower {ab['iters']} iterations an arm (baseline, aug) -> held-out "
        "Evaluator (tools/aug_ab.py's chain)")
    zero_counts()
    t0 = time.perf_counter()
    out = aug_ab.run(iters=ab["iters"], speaker_iters=ab["speaker_iters"], n_aug=ab["n_aug"],
                     arms="baseline,aug", feat_dropout=0.6, movement_frame=True, seed=88,
                     device=device, log=say, on_stage=stage, **ab["sizes"])
    seconds = time.perf_counter() - t0
    setup = out["setup"]
    records, n_aug = out["records"], ab["n_aug"]
    if not len(records) == out["aug_instances"] == n_aug:
        fail(f"{len(records)} records, {out['aug_instances']} instances; expected {n_aug}")
    for rec in records:
        g = setup.world.graphs[rec["scan"]]
        idx = [g.index[p] for p in rec["path"]]
        if len(idx) < 2 or not all(g.adjacency[a, b] for a, b in zip(idx, idx[1:])):
            fail(f"record {rec['path_id']}: {rec['path']} is not a walk over graph edges")
    say(f"  {n_aug} records, each a walk over graph edges ({min(len(r['path']) for r in records)}"
        f"-{max(len(r['path']) for r in records)} viewpoints)")
    iters, cfg = ab["iters"], setup.cfg
    check_launches("speaker steps and augment", {k: counts["speaker"][k] + counts["augment"][k]
                                                  for k in COUNTED}, {})
    step_want = follower_launches(cfg, setup.seq)
    n_val = -(-len(setup.val_inst) // setup.batch)
    launches = {}
    for arm in ("baseline", "aug"):
        total = counts[f"train_{arm}"]
        per_step = {k: v // iters for k, v in total.items()}
        check_launches(f"{arm}: a follower step", per_step, step_want)
        if not REHEARSAL and total != {k: iters * v for k, v in per_step.items()}:
            fail(f"{arm}: launches over {iters} steps {total}")
        check_launches(f"{arm}: the held-out evaluation ({n_val} batches)",
                       counts[f"val_{arm}"],
                       {k: n_val * v for k, v in follower_launches(cfg, setup.seq,
                                                                   backward=False).items()})
        launches[arm] = per_step
    logged = out["speaker_losses"][aug_ab.SPEAKER_LOG_EVERY - 1::aug_ab.SPEAKER_LOG_EVERY]
    window = min(50, iters // 2)
    ratios = {arm: float(np.mean(run["losses"][-window:]) / np.mean(run["losses"][:window]))
              for arm, run in out["arms"].items()}
    fid, control = out["fidelity"], out["control"]
    over = round(fid["hop_acc"] - control["hop_acc"], 3)
    if not (np.isfinite(out["speaker_losses"]).all()
            and all(np.isfinite(run["losses"]).all() for run in out["arms"].values())):
        fail("non-finite losses in the A/B")
    sp_ratio = logged[-1] / logged[0] if len(logged) >= 2 else float("nan")
    gates = {f"speaker word CE last / first log <= {AUG_AB_GATES['speaker_ce_ratio']}":
             sp_ratio <= AUG_AB_GATES["speaker_ce_ratio"],
             f"parse >= {AUG_AB_GATES['parse']}": fid["parse"] >= AUG_AB_GATES["parse"],
             f"hop_acc >= {AUG_AB_GATES['hop_acc']}": fid["hop_acc"] >= AUG_AB_GATES["hop_acc"],
             f"hop_acc - control's >= {AUG_AB_GATES['over_control']}":
             over >= AUG_AB_GATES["over_control"],
             **{f"{arm} loss ratio <= {AUG_AB_GATES['loss_ratio']}":
                r <= AUG_AB_GATES["loss_ratio"] for arm, r in ratios.items()}}
    vals = {arm: {k: v for k, v in run["val"].items() if k != "tag"}
            for arm, run in out["arms"].items()}
    delta_gp = out["delta"]["gp"]
    say(f"  speaker word CE at its logs {[round(x, 4) for x in logged]} (last / first "
        f"{sp_ratio:.3f}); fidelity {fid}; the control (captions rotated one walk on) "
        f"hop_acc {control['hop_acc']}, len_mae {control['len_mae']}: hop_acc over it "
        f"{over:+.3f}; loss ratios (last {window} / first {window}) "
        + ", ".join(f"{arm} {r:.3f}" for arm, r in ratios.items()))
    say("  held-out: " + "; ".join(f"{arm} " + ", ".join(f"{k} {v}" for k, v in m.items())
                                    for arm, m in vals.items())
        + f"; ΔGP (aug - baseline) {delta_gp:+.3f} m, not gated; {seconds:.1f} s "
        f"({', '.join(f'{k} {v:.1f}' for k, v in out['seconds'].items())})")
    say("  gates: " + ", ".join(f"{k} {'met' if v else 'MISSED'}" for k, v in gates.items())
        + (" (reported, not enforced, at the rehearsal's size)" if REHEARSAL else ""))
    if not REHEARSAL and not all(gates.values()):
        fail(f"the A/B missed {[k for k, v in gates.items() if not v]}")
    del out
    release()
    return {"fidelity": {k: v for k, v in fid.items() if k != "n"},
            "control": {k: v for k, v in control.items() if k != "n"}, "arms": vals,
            "delta_gp": delta_gp, "speaker_ce_logged": logged, "loss_ratios": ratios,
            "iterations": {"speaker": ab["speaker_iters"], "follower": iters},
            "n_aug": n_aug, "seconds": seconds,
            "launches": {"speaker_and_augment": {k: counts["speaker"][k] + counts["augment"][k]
                                                 for k in COUNTED},
                         "follower_step": launches["baseline"],
                         "eval_batch": {k: v // n_val for k, v in counts["val_baseline"].items()}}}


# -- phase 22: the run CLI ---------------------------------------------------------------

CLI_FINETUNE = {"K1f": 12, "K1b": 12, "K2f": 25, "K2b": 25}
# The --debug pretraining batches carry 36 x 5 = 180 regions, bucketed to 192:
# S 704 = 512 + 192 is no multiple of 128, so the fused gate refuses and the
# plain attention runs (in both packages): no K4 (K1, K5) launch.
CLI_PRETRAIN = {"K3f": 1, "K3b": 1, "K2f": 26, "K2b": 26}


class BoundaryHooks:
    """Host-clock stamps and kernel launch counts at each logging boundary
    of the fine-tuning, turn-based and classifier trainers (their shared
    loop's ``_log``) and of the pretraining loop (``pretrain._fetch``): with
    logging_steps 1 every iteration ends in its one read-back, so the stamps
    time iterations and the counts' differences are each iteration's
    launches."""

    def __init__(self):
        from visitron_torch.train import loop, pretrain as pretrain_mod

        self.loop, self.pretrain = loop, pretrain_mod
        self.orig_log = loop._log
        self.orig_fetch = pretrain_mod._fetch
        self.marks: list = []

    def __enter__(self):
        hooks, orig_log, orig_fetch = self, self.orig_log, self.orig_fetch

        def log(logger, metrics, it, *rest):
            orig_log(logger, metrics, it, *rest)
            hooks.marks.append((it, time.perf_counter(), read_counts()))

        def fetch(bundle):
            out = orig_fetch(bundle)
            hooks.marks.append((len(hooks.marks) + 1, time.perf_counter(), read_counts()))
            return out

        self.loop._log = log
        self.pretrain._fetch = fetch
        return self

    def __exit__(self, *exc):
        self.loop._log = self.orig_log
        self.pretrain._fetch = self.orig_fetch
        return False

    def run(self, argv, device, base=None) -> list:
        """``run.main(argv)``: [(iteration, ms since the previous boundary,
        launches in between)] of its boundaries; the first interval counts
        from just before the call."""
        from visitron_torch import run as cli

        self.marks = []
        zero_counts()
        t0 = time.perf_counter()
        cli.main(argv, device=device)
        out, prev_t, prev_c = [], t0, {k: 0 for k in COUNTED}
        for it, t, c in self.marks:
            out.append((it, (t - prev_t) * 1e3, {k: c[k] - prev_c[k] for k in c}))
            prev_t, prev_c = t, c
        return out


def check_iteration_launches(name: str, rows: list, want: dict) -> dict:
    per = [c for _, _, c in rows]
    want = {k: want.get(k, 0) for k in COUNTED}
    say(f"  {name}: launches per iteration {per[-1]} (every iteration alike: "
        f"{all(c == per[-1] for c in per)})")
    if not REHEARSAL and any(c != want for c in per):
        fail(f"{name}: launches per iteration {per}, expected {want}")
    return per[-1]


def checkpoint_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def time_saves(out: str, step: int, device) -> dict:
    """Checkpoint ``step`` of ``out`` back on the card, then saved again
    synchronously and asynchronously: ms of the call (async: the
    device-to-host copy only) and of the write behind it, and the size."""
    from visitron_torch.train.checkpoint import CheckpointManager

    def to_device(tree):
        if isinstance(tree, dict):
            return {k: to_device(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_device(v) for v in tree]
        return tree.to(device) if isinstance(tree, torch.Tensor) else tree

    src = CheckpointManager(out)
    params = to_device(src.restore_raw(step))
    opt = to_device(src.restore_raw(step, "opt_state"))
    sync()
    res = {}
    for mode in ("sync", "async"):
        mgr = CheckpointManager(os.path.join(out, f"saves_{mode}"), async_save=mode == "async")
        t0 = time.perf_counter()
        path = mgr.save(1, params, opt)
        t1 = time.perf_counter()
        mgr.wait_until_finished()
        t2 = time.perf_counter()
        res[mode] = {"call_ms": (t1 - t0) * 1e3, "durable_ms": (t2 - t0) * 1e3,
                     "bytes": checkpoint_bytes(path)}
        if mgr.steps() != [1]:
            fail(f"{mode} save: no completed checkpoint")
    for mode, r in res.items():
        say(f"  checkpoint save ({mode}): call {r['call_ms']:.1f} ms, durable after "
            f"{r['durable_ms']:.1f} ms, {r['bytes'] / 2 ** 30:.3f} GiB")
    if not REHEARSAL and res["async"]["call_ms"] > 0.5 * res["sync"]["durable_ms"]:
        fail("an asynchronous save held the caller for the write")
    return res


def trace_idle(path: str, what: str):
    """Device busy time and idle share over the window of a torch.profiler
    chrome trace (the trainer's ``--profile_steps`` output); None when the
    session recorded no device kernel (it happens now and then)."""
    events = [e for e in json.load(open(path))["traceEvents"] if e.get("ph") == "X"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if REHEARSAL or not kernels:
        say(f"  profile of {what}: {len(events)} events, no device kernel recorded")
        return None
    busy = sum(e["dur"] for e in kernels) / 1e3
    span = (max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)) / 1e3
    say(f"  profile of {what}: {len(kernels)} device kernels, busy {busy:.2f} ms of "
        f"{span:.2f} ms (idle share {1 - busy / span:.1%}; the window includes the "
        "profiler's own cost)")
    return 1 - busy / span


@contextlib.contextmanager
def cli_bert():
    """The CLI phases' BERT: the workspace's BERT-base on the card; in a
    rehearsal a tiny one (2 layers, hidden 128) on the CPU."""
    from visitron_torch.train import workspace as ws_mod

    orig_bert = ws_mod.Workspace.__dict__["_bert_config"]
    if REHEARSAL:
        ws_mod.Workspace._bert_config = staticmethod(lambda cfg, tok: orig_bert.__func__(
            cfg, tok).replace(num_hidden_layers=2, hidden_size=128, num_attention_heads=2,
                              intermediate_size=256))
    try:
        yield
    finally:
        ws_mod.Workspace._bert_config = orig_bert


# Scale-only overrides of the CLI phases in a rehearsal (the card runs the
# configs' lengths).
REHEARSAL_SEQ = ["--max_seq_length", "128"]


def phase_cli(device, tmp: str) -> dict:
    """22. ``python -m visitron_torch.run`` through ``run.main`` on the
    --debug world: viewpoint (ndh_oscar_setting.json) 4 iterations, resume
    to 6, val of checkpoint 6, --test_only; pretrain (pretrain_ndh_r2r.json)
    one epoch; ablation 3's fine-tune from that pretraining output.  The
    outputs stay under ``tmp`` (the viewpoint run's in ``tmp/viewpoint``)."""
    from visitron_torch.train.checkpoint import CheckpointManager

    say("cli: python -m visitron_torch.run (run.main) on the --debug world"
        + ("" if REHEARSAL else ", BERT-base, bf16"))
    t_phase = time.perf_counter()
    vp_scale, pt_scale = [], []
    if REHEARSAL:
        vp_scale = REHEARSAL_SEQ
        pt_scale = vp_scale + ["--max_img_seq_length", "64", "--per_gpu_train_batch_size", "16"]
    else:
        torch.cuda.reset_peak_memory_stats()
    out = {}
    with BoundaryHooks() as hooks:
        vp = os.path.join(tmp, "viewpoint")
        vp_args = ["viewpoint", "--config", "run_configs/viewpoint_train/ndh_oscar_setting.json",
                   "--debug", "--logging_steps", "1", "--saving_steps", "4",
                   "--output_dir", vp] + vp_scale
        rows = hooks.run(vp_args + ["--num_iterations", "4", "--eval_iters", "4"], device)
        ms = [r[1] for r in rows[1:]]
        say(f"  viewpoint, 4 iterations (batch 4, trusted_path: 40-step episodes, "
            f"sample feedback): ms per iteration {', '.join(f'{m:.1f}' for m in ms)} "
            f"(the first, with set-up, {rows[0][1]:.1f})")
        out["vp_ms"] = float(np.median(ms))
        out["vp_counts"] = check_iteration_launches("viewpoint", rows, CLI_FINETUNE)
        rows = hooks.run(vp_args + ["--num_iterations", "6", "--resume",
                                    "--eval_iters", "6", "--profile_steps", "1"], device)
        mgr = CheckpointManager(vp)
        resumed = [r[0] for r in rows]
        count = mgr.restore_raw(6, "opt_state")[1]["count"]
        say(f"  resume: checkpoints {mgr.steps()}, the resumed run's iterations "
            f"{resumed}, Adam count at checkpoint-6 {count}, ms of iteration 6 "
            f"{rows[-1][1]:.1f} (under the profiler)")
        out["vp_idle"] = trace_idle(os.path.join(vp, "profile", "trace.json"),
                                    "iteration 6's train step (--profile_steps 1)")
        if mgr.steps() != [4, 6] or resumed != [5, 6] or count != 6:
            fail("resume did not continue from checkpoint-4 to 6")
        check_iteration_launches("viewpoint, resumed", rows, CLI_FINETUNE)
        say("  resume OK")
        with open(os.path.join(vp, "val.csv")) as f:
            rows = list(csv.DictReader(f))  # one row a split
        summary = {k: float(v) for r in rows for k, v in r.items() if k != "step" and v}
        say("  val of checkpoint-6, Evaluator: " + ", ".join(
            f"{k} {v:.4f}" for k, v in sorted(summary.items())))
        if ({int(float(r["step"])) for r in rows} != {6} or len(summary) < 20
                or not all(np.isfinite(v) for v in summary.values())):
            fail(f"val of checkpoint-6: {rows}")
        for split in ("val_seen", "val_unseen"):
            if not os.path.exists(os.path.join(vp, f"preds_{split}_6.json")):
                fail(f"no predictions of {split}")
        hooks.run(vp_args + ["--test_only"], device)
        sub = json.load(open(os.path.join(vp, "submission_test.json")))
        if not sub or any(len({p[0] for p in s["trajectory"]}) != len(s["trajectory"])
                          for s in sub):
            fail("--test_only: no submission, or a viewpoint visited twice")
        say(f"  --test_only: submission_test.json with {len(sub)} trajectories")
        out["saves"] = time_saves(vp, 6, device)

        pre = os.path.join(tmp, "pretrain")
        rows = hooks.run(["pretrain", "--config", "run_configs/pretrain/pretrain_ndh_r2r.json",
                          "--debug", "--num_epochs", "1", "--logging_steps", "1",
                          "--output_dir", pre] + pt_scale, device)
        ms = [r[1] for r in rows[1:]]
        steps = CheckpointManager(pre).steps()
        say(f"  pretrain, one epoch of {len(rows)} iterations: ms per "
            f"iteration median {np.median(ms):.1f} (range {min(ms):.1f}-{max(ms):.1f}; "
            f"the first, with set-up, {rows[0][1]:.1f}); checkpoints {steps}, "
            f"{checkpoint_bytes(os.path.join(pre, f'checkpoint-{steps[-1]}')) / 2 ** 30:.3f} GiB")
        if steps != [len(rows)]:
            fail(f"pretrain: checkpoints {steps} after {len(rows)} iterations")
        out["pt_ms"] = float(np.median(ms))
        out["pt_counts"] = check_iteration_launches("pretrain", rows, CLI_PRETRAIN)
        with open(os.path.join(pre, "train.csv")) as f:
            swept = {k: float(v) for r in csv.DictReader(f) for k, v in r.items()
                     if k.endswith("/loss") and v}
        say("  pretrain val sweeps: " + ", ".join(f"{k} {v:.4f}" for k, v in sorted(swept.items())))
        # Each of ndh / r2r x val_seen / val_unseen with a full batch (at the
        # rehearsal's batch 16 one is too small and skipped, as in the loop).
        if len(swept) < (3 if REHEARSAL else 4) or not all(np.isfinite(v)
                                                             for v in swept.values()):
            fail(f"pretrain val sweeps {swept}")

        abl = os.path.join(tmp, "ablation3")
        # The fine-tune config sets max_seq_length 768, the pretraining
        # config 512: the graft's shape rule takes the pretraining length.
        rows = hooks.run(["viewpoint", "--config",
                          "run_configs/ablations/3_only_oscar_mlm-finetune_ndh.json",
                          "--debug", "--num_iterations", "2", "--saving_steps", "2",
                          "--logging_steps", "1", "--eval_iters", "2",
                          "--max_seq_length", "512", "--model_name_or_path", pre,
                          "--output_dir", abl], device)
        check_iteration_launches("ablation 3 fine-tune", rows, CLI_FINETUNE)
        pretrained = CheckpointManager(pre).restore_raw(steps[-1])
        enc = CheckpointManager(abl).restore_raw(2)["encoder"]
        moved = max(float((enc[n] - pretrained["bert." + n[len("bert.bert."):]]).abs().max())
                    for n in enc if n.startswith("bert.bert.")
                    and "bert." + n[len("bert.bert."):] in pretrained)
        say(f"  ablation 3 fine-tune from the pretraining output: 2 iterations "
            f"(ms {rows[-1][1]:.1f}), its BERT within {moved:.2e} of the pretrained "
            f"weights after 2 Adam steps at lr 5e-5")
        if moved > 4 * 5e-5 + 1e-6:
            fail("the fine-tune did not start from the pretraining checkpoint")
    out["peak"] = 0 if REHEARSAL else torch.cuda.max_memory_allocated()
    say(f"  peak memory {out['peak'] / 2 ** 30:.2f} GiB; phase {time.perf_counter() - t_phase:.1f} s")
    return out


# -- phases 23-26: turn-based, classifier, the Oscar import, datagen ---------------------

# Launches per iteration: the turn-based step runs the viewpoint step's
# encoder forward and backward; the classifier step one frozen (E*B)-row
# encoder call without gradients; a turn-based argmax rollout batch one
# encoder forward.
CLI_TURN_BASED = CLI_FINETUNE
TURN_ROLLOUT = {"K1f": 12, "K2f": 25}
CLI_CLASSIFIER = {"K1f": 12, "K2f": 25}
TURN_CONFIG = "run_configs/turn_based_train/ndh_oscar_setting.json"


def check_val_csv(path: str, step: int, n_values: int) -> dict:
    """{metric: value} of the val.csv rows of checkpoint ``step``; fails
    unless there are ``n_values`` of them, all finite."""
    with open(path) as f:
        rows = list(csv.DictReader(f))
    values = {k: float(v) for r in rows for k, v in r.items() if k != "step" and v}
    if ({int(float(r["step"])) for r in rows} != {step} or len(values) != n_values
            or not all(np.isfinite(v) for v in values.values())):
        fail(f"val of checkpoint-{step}: {rows}")
    return values


def phase_turn_based(device, tmp: str, cli: dict) -> dict:
    """23. ``run turn_based`` with turn_based_train/ndh_oscar_setting.json on
    the --debug world (batch 4, player path: 40-step episodes): 4
    iterations, --resume to 6, val of checkpoints 4 and 6; ms and launches
    per iteration; one argmax rollout batch of the val split from
    checkpoint 6: its launches, read-backs and synchronising calls a step."""
    from visitron_torch.train.checkpoint import CheckpointManager

    say("turn_based: python -m visitron_torch.run turn_based on the --debug world"
        + ("" if REHEARSAL else ", BERT-base, bf16"))
    t_phase = time.perf_counter()
    out = {}
    tb = os.path.join(tmp, "turn_based")
    args = ["turn_based", "--config", TURN_CONFIG, "--debug", "--logging_steps", "1",
            "--saving_steps", "4", "--output_dir", tb] + (REHEARSAL_SEQ if REHEARSAL else [])
    with BoundaryHooks() as hooks:
        rows = hooks.run(args + ["--num_iterations", "4", "--eval_iters", "4"], device)
        ms = [r[1] for r in rows[1:]]
        out["ms"] = float(np.median(ms))
        say(f"  4 iterations (batch 4, 40-step episodes, teacher forcing): ms per "
            f"iteration {', '.join(f'{m:.1f}' for m in ms)} (the first, with set-up, "
            f"{rows[0][1]:.1f}); median {out['ms']:.1f}, {out['ms'] / cli['vp_ms']:.2f}x "
            f"phase 22's viewpoint iteration ({cli['vp_ms']:.1f})")
        out["counts"] = check_iteration_launches("turn_based", rows, CLI_TURN_BASED)
        rows = hooks.run(args + ["--num_iterations", "6", "--resume", "--eval_iters", "6"],
                         device)
    mgr = CheckpointManager(tb)
    resumed = [r[0] for r in rows]
    count = mgr.restore_raw(6, "opt_state")[1]["count"]
    say(f"  resume: checkpoints {mgr.steps()}, the resumed run's iterations {resumed}, "
        f"Adam count at checkpoint-6 {count}")
    if mgr.steps() != [4, 6] or resumed != [5, 6] or count != 6:
        fail("turn_based: resume did not continue from checkpoint-4 to 6")
    check_iteration_launches("turn_based, resumed", rows, CLI_TURN_BASED)
    summary = check_val_csv(os.path.join(tb, "val.csv"), 6, 22)
    say("  val of checkpoint-6: " + ", ".join(f"{k} {v:.4f}" for k, v in sorted(summary.items())))
    if not os.path.exists(os.path.join(tb, "preds_turn_val_seen_6.json")):
        fail("turn_based: no predictions of val_seen")
    out["rollout"] = turn_rollout(device, tb)
    say(f"  phase {time.perf_counter() - t_phase:.1f} s")
    return out


def turn_rollout(device, tb: str) -> dict:
    """One argmax rollout batch (4 val_seen episodes, from checkpoint 6 of
    ``tb``): launches, the (B,) action read-backs the host needs a step (the
    agent's count) and every synchronising call a step (sync debug mode)."""
    import dataclasses
    import warnings

    from visitron_torch.config import RunConfig
    from visitron_torch.train.turn_based import TurnBasedTrainer
    from visitron_torch.train.workspace import Workspace

    cfg = dataclasses.replace(RunConfig.from_json(TURN_CONFIG), debug=True, output_dir=tb,
                              **({"max_seq_length": 128} if REHEARSAL else {}))
    trainer = TurnBasedTrainer(cfg, Workspace.synthetic_workspace(cfg, device=device),
                               device=device)
    agent = trainer.agent
    params = trainer.ckpt.restore(6, {"params": agent.init_params()})["params"]
    batch = next(iter(trainer._batcher(trainer._instances(["val_seen"]), 4).eval_batches()))
    steps = 0
    orig_step = agent.decode_step

    def counted_step(*args, **kw):
        nonlocal steps
        steps += 1
        return orig_step(*args, **kw)

    agent.decode_step = counted_step
    with torch.inference_mode():
        agent.rollout_student(params, batch)  # warm-up
        sync()
        zero_counts()
        reads, steps = agent.readbacks, 0
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if not REHEARSAL:
                torch.cuda.set_sync_debug_mode("warn")
            t0 = time.perf_counter()
            try:
                trajs = agent.rollout_student(params, batch)
            finally:
                if not REHEARSAL:
                    torch.cuda.set_sync_debug_mode(0)
            sync()
            ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    readbacks = (agent.readbacks - reads) / steps
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    say(f"  argmax rollout of 4 episodes, {steps} decoder steps: {ms:.1f} ms (under the "
        f"sync debug mode), launches {counts}; (B,) action read-backs per step "
        f"{readbacks:.2f}; synchronising calls per step "
        + ("not measured on the CPU" if REHEARSAL else f"{syncs / steps:.2f}")
        + f"; path lengths {[len(t['path']) for t in trajs]}")
    want = {k: TURN_ROLLOUT.get(k, 0) for k in COUNTED}
    if not REHEARSAL and counts != want:
        fail(f"turn-based rollout: launches {counts}, expected {want}")
    return {"counts": counts, "steps": steps, "readbacks_per_step": readbacks,
            "syncs_per_step": None if REHEARSAL else syncs / steps, "ms": ms}


def phase_turn_based_agreement(device, sizes, sl) -> None:
    """One fp32 turn-based train step with every dropout at 0 on a 2-item
    batch (20-step episodes): the card (kernels) against the CPU."""
    from visitron_torch.agents.turn_based import TurnBasedAgent

    say("turn_based agreement: one fp32 step, dropouts 0, card vs CPU on a 2-item batch")
    agents = {}
    for dev in (device, "cpu"):
        rt = NavRuntime.build(sl["world"].graphs, sl["table"], device_dtype=torch.float32,
                              device=dev)
        cfg = BertConfig(vocab_size=len(sl["tok"]), max_position_embeddings=sizes["seq"],
                         type_vocab_size=4, dtype=torch.float32, hidden_dropout_prob=0.0,
                         attention_probs_dropout_prob=0.0, **sizes["bert"])
        agents[dev] = TurnBasedAgent(cfg, rt, feature_dim=sizes["feat"], rnn_dim=sizes["rnn"],
                                     encoder_hidden_size=sizes["rnn"], dropout=0.0, device=dev)
    batcher = NavEpisodeBatcher(sl["train_instances"][:2], agents["cpu"].runtime,
                                batch_size=2, path_type="trusted_path")
    batch = batcher.with_turn_teacher(next(batcher.train_batches(1)), 20)
    out = {}
    for dev, agent in agents.items():
        state = agent.init_state()
        loss, _, grads = agent.value_and_grads(state["params"], lambda p: (
            agent.episode_loss(p, agent.trim_batch(batch)), None))
        new, _ = agent.train_step_fn()(state, batch)
        out[dev] = step_record(loss, grads, state, new)
    check_step_agreement(device, out, agents["cpu"].learning_rate)


def phase_classifier(device, tmp: str, cli: dict) -> dict:
    """24. ``run classifier`` with classifier/classifier.json (batch 1,
    40-step episodes, only the question head trains) from phase 22's
    viewpoint output: 4 iterations, launches and ms per iteration, the
    encoder and the nav decoder bit for bit as in the viewpoint checkpoint;
    then classifier/classifier_val.json (0 iterations) on the same output:
    the metrics of checkpoint 4 again."""
    from visitron_torch.train.checkpoint import CheckpointManager

    say("classifier: python -m visitron_torch.run classifier from phase 22's viewpoint run"
        + ("" if REHEARSAL else ", BERT-base, bf16"))
    t_phase = time.perf_counter()
    from visitron_torch.config import RunConfig

    vp, cl = os.path.join(tmp, "viewpoint"), os.path.join(tmp, "classifier")
    # The classifier configs keep max_seq_length 512, the viewpoint config
    # sets 768: the encoder's position table must have the viewpoint run's
    # rows (both packages refuse another shape).
    seq = REHEARSAL_SEQ if REHEARSAL else ["--max_seq_length", str(RunConfig.from_json(
        "run_configs/viewpoint_train/ndh_oscar_setting.json").max_seq_length)]
    out = {}
    with BoundaryHooks() as hooks:
        rows = hooks.run(["classifier", "--config", "run_configs/classifier/classifier.json",
                          "--debug", "--num_iterations", "4", "--saving_steps", "4",
                          "--logging_steps", "1", "--model_name_or_path", vp,
                          "--output_dir", cl] + seq, device)
        ms = [r[1] for r in rows[1:]]
        out["ms"] = float(np.median(ms))
        say(f"  4 iterations (batch 1, 40-step episodes): ms per iteration "
            f"{', '.join(f'{m:.1f}' for m in ms)} (the first, with set-up, {rows[0][1]:.1f}); "
            f"median {out['ms']:.1f}, {out['ms'] / cli['vp_ms']:.2f}x phase 22's viewpoint "
            f"iteration")
        out["counts"] = check_iteration_launches("classifier", rows, CLI_CLASSIFIER)
        first = check_val_csv(os.path.join(cl, "val.csv"), 4, 14)
        hooks.run(["classifier", "--config", "run_configs/classifier/classifier_val.json",
                   "--debug", "--model_name_or_path", vp, "--output_dir", cl] + seq, device)
    again = check_val_csv(os.path.join(cl, "val.csv"), 4, 14)
    say("  val of checkpoint-4: " + ", ".join(f"{k} {v:.4f}" for k, v in sorted(first.items())))
    if again != first:
        fail(f"classifier_val.json: {again} != the training run's val {first}")
    nav = CheckpointManager(vp).restore_raw(CheckpointManager(vp).latest())
    got = CheckpointManager(cl).restore_raw(4)
    frozen = [(part, n) for part in ("encoder", "decoder") for n in got[part]
              if "question_linear" not in n]
    changed = [f"{p}/{n}" for p, n in frozen if not torch.equal(got[p][n], nav[p][n])]
    head = [n for n in got["decoder"] if "question_linear" in n]
    say(f"  after 4 steps: {len(frozen) - len(changed)} of {len(frozen)} encoder and nav "
        f"decoder tensors bit for bit as in the viewpoint checkpoint; question head "
        f"{head}, finite {all(bool(torch.isfinite(got['decoder'][n]).all()) for n in head)}")
    if changed or not head:
        fail(f"classifier: frozen tensors changed: {changed[:5]}")
    say(f"  phase {time.perf_counter() - t_phase:.1f} s")
    return out


def hf_bert_state(cfg: BertConfig, seed: int) -> dict:
    """A BERT checkpoint in the HF / pytorch_transformers layout (``bert.``
    names, per-layer query / key / value) at ``cfg``'s widths and the
    published BERT-base tables (30522 words, 512 positions, 2 types), drawn
    from a seeded generator: normal(0, 0.02) weights, LayerNorm scales near
    1, small biases."""
    g = torch.Generator().manual_seed(seed)
    h, inter = cfg.hidden_size, cfg.intermediate_size

    def w(*shape, scale=0.02):
        return torch.randn(shape, generator=g) * scale

    def ln(prefix):
        return {prefix + ".weight": 1.0 + w(h), prefix + ".bias": w(h)}

    state = {"embeddings.word_embeddings.weight": w(30522, h),
             "embeddings.position_embeddings.weight": w(512, h),
             "embeddings.token_type_embeddings.weight": w(2, h),
             **ln("embeddings.LayerNorm"),
             "pooler.dense.weight": w(h, h), "pooler.dense.bias": w(h)}
    for i in range(cfg.num_hidden_layers):
        pre = f"encoder.layer.{i}."
        for name in ("query", "key", "value"):
            state[pre + f"attention.self.{name}.weight"] = w(h, h)
            state[pre + f"attention.self.{name}.bias"] = w(h)
        state.update({pre + "attention.output.dense.weight": w(h, h),
                      pre + "attention.output.dense.bias": w(h),
                      **ln(pre + "attention.output.LayerNorm"),
                      pre + "intermediate.dense.weight": w(inter, h),
                      pre + "intermediate.dense.bias": w(inter),
                      pre + "output.dense.weight": w(h, inter),
                      pre + "output.dense.bias": w(h),
                      **ln(pre + "output.LayerNorm")})
    return {"bert." + k: v for k, v in state.items()}


def phase_oscar(device, tmp: str) -> dict:
    """25. The Oscar / HuggingFace import: a seeded HF-layout
    pytorch_model.bin at the run's BERT widths, then ``run viewpoint
    --debug --model_name_or_path <dir>`` for 2 iterations: the encoder's
    BERT equals the file's converted tensors before the first step (words
    cut, positions and types grown to the workspace's tables) and is within
    2 Adam steps of them after; launches per iteration."""
    from visitron_torch.models.oscar_import import convert_bert_state_dict
    from visitron_torch.train import finetune
    from visitron_torch.train.checkpoint import CheckpointManager
    from visitron_torch.train.workspace import Workspace

    say("oscar import: run viewpoint --model_name_or_path <HF-layout pytorch_model.bin>")
    t_phase = time.perf_counter()
    hf_dir, out_dir = os.path.join(tmp, "oscar"), os.path.join(tmp, "oscar_finetune")
    os.makedirs(hf_dir)
    from visitron_torch.config import RunConfig

    # The widths the run's workspace builds (BERT-base; tiny in a rehearsal).
    state = hf_bert_state(Workspace._bert_config(RunConfig(), range(30522)), SEED)
    t0 = time.perf_counter()
    torch.save(state, os.path.join(hf_dir, "pytorch_model.bin"))
    size = os.path.getsize(os.path.join(hf_dir, "pytorch_model.bin"))
    say(f"  wrote {len(state)} tensors, {size / 2 ** 30:.3f} GiB in "
        f"{(time.perf_counter() - t0) * 1e3:.0f} ms")
    seen = {}
    orig = finetune.ViewpointTrainer._pretrained_params

    def capture(trainer, params):
        params = orig(trainer, params)
        seen["cfg"] = trainer.ws.bert_config
        seen["enc"] = {k: v.detach().cpu().clone() for k, v in params["encoder"].items()
                       if k.startswith("bert.bert.")}
        return params

    finetune.ViewpointTrainer._pretrained_params = capture
    try:
        with BoundaryHooks() as hooks:
            rows = hooks.run(["viewpoint", "--config",
                              "run_configs/viewpoint_train/ndh_oscar_setting.json", "--debug",
                              "--num_iterations", "2", "--saving_steps", "2",
                              "--logging_steps", "1", "--eval_iters", "2",
                              "--model_name_or_path", hf_dir, "--output_dir", out_dir]
                             + (REHEARSAL_SEQ if REHEARSAL else []), device)
    finally:
        finetune.ViewpointTrainer._pretrained_params = orig
    counts = check_iteration_launches("viewpoint from the HF file", rows, CLI_FINETUNE)
    want = convert_bert_state_dict({k[len("bert."):]: v for k, v in state.items()},
                                   seen["cfg"])
    differ = [n for n, t in want.items() if not torch.equal(seen["enc"]["bert.bert." + n], t)]
    if differ or len(want) != len(seen["enc"]):
        fail(f"the encoder's BERT before the first step is not the file's: {differ[:5]}")
    after = CheckpointManager(out_dir).restore_raw(2)["encoder"]
    moved = max(float((after["bert.bert." + n] - t).abs().max()) for n, t in want.items())
    words = want["word_embeddings.weight"].shape[0]
    say(f"  before the first step the encoder's {len(want)} BERT tensors equal the file's "
        f"(word table cut 30522 -> {words} rows, positions 512 -> "
        f"{want['embeddings.position_embeddings.weight'].shape[0]}, types 2 -> "
        f"{want['embeddings.token_type_embeddings.weight'].shape[0]}); after 2 steps within "
        f"{moved:.2e} (lr 5e-5); ms of iteration 2 {rows[-1][1]:.1f}")
    if moved > 4 * 5e-5 + 1e-6:
        fail("the fine-tune did not start from the HF file's weights")
    say(f"  phase {time.perf_counter() - t_phase:.1f} s")
    return {"counts": counts}


def phase_datagen(device, tmp: str) -> None:
    """26. ``run datagen --debug --add_r2r_data``: the NDH and R2R files of
    each split exist and equal generate_pretrain_examples over the same
    task data."""
    from visitron_torch import run as cli
    from visitron_torch.config import RunConfig
    from visitron_torch.pipelines import generate_pretrain_examples
    from visitron_torch.train.workspace import Workspace

    say("datagen: python -m visitron_torch.run datagen --debug --add_r2r_data")
    t0 = time.perf_counter()
    out = os.path.join(tmp, "datagen")
    cli.main(["datagen", "--debug", "--add_r2r_data", "--output_dir", out], device=device)
    ms = (time.perf_counter() - t0) * 1e3
    cfg = RunConfig(debug=True, output_dir=out)
    ws = Workspace.synthetic_workspace(cfg, device=device)
    root = os.path.join(out, "synthetic_task_data")
    tables = {s: ws.runtime.tables[s] for s in ws.graphs}
    n = 0
    for ds in ("NDH", "R2R"):
        for split in ("train", "val_seen", "val_unseen"):
            path = os.path.join(root, "pretrain_data", f"{ds}_{split}.json")
            if not os.path.exists(path):
                fail(f"datagen wrote no {path}")
            got = json.load(open(path))
            want = json.loads(json.dumps(generate_pretrain_examples(root, [split], ds,
                                                                    ws.graphs, tables)))
            if got != want or not got:
                fail(f"datagen: {ds}_{split}.json differs from generate_pretrain_examples")
            n += len(got)
    say(f"  6 files, {n} examples, equal to generate_pretrain_examples; {ms:.0f} ms")


# -- phases 27-28: the speaker, back-translation augmentation, --aug_data ------------------

SPEAKER_CONFIG = "run_configs/pipeline/speaker.json"
AUGMENT_CONFIG = "run_configs/pipeline/augment.json"
FINETUNE_CONFIG = "run_configs/viewpoint_train/ndh_oscar_setting.json"
# The speaker launches none of the ported kernels (no BERT; its word CE is a
# plain fp32 cross-entropy, not K3).
CLI_SPEAKER: dict = {}
# Greedy decoding compares argmaxes: tokens are compared up to the first
# step whose top-2 logit margin (on the CPU) is below this.
GREEDY_MARGIN = 1e-4


def speaker_tokenizer(vocab_size: int) -> WordPieceTokenizer:
    """The synthetic world's WordPiece vocabulary grown to ``vocab_size``
    (BERT-base-uncased's 30522) with filler words ``w<i>``."""
    vocab = build_wordpiece_vocab([" ".join(_WORDS), " ".join(_TARGETS)], vocab_size=4096)
    return WordPieceTokenizer(vocab + [f"w{i}" for i in range(len(vocab), vocab_size)])


def speaker_batches(sp, instances, tok, n: int, batch_size: int, seed: int) -> list:
    """``n`` teacher batches (trusted path) with word ids drawn from a seed:
    each item's length is its dialog's wordpiece count (at most max_words - 1),
    its ids uniform over the non-special vocabulary."""
    from visitron_torch.agents.speaker import SpeakerAgent

    rng = np.random.default_rng(seed)
    batcher = NavEpisodeBatcher(instances, sp.runtime, batch_size=batch_size,
                                path_type="trusted_path", seed=seed)
    text = {i.inst_idx: SpeakerAgent.instance_text(i) for i in instances}
    first = len(tok.all_special_tokens)
    out = []
    for batch in batcher.train_batches(n, episode_len=sp.episode_len):
        words = np.full((batch_size, sp.max_words + 1), sp.pad_id, np.int32)
        for i, idx in enumerate(batch["inst_idx"]):
            ids = rng.integers(first, sp.vocab_size,
                               size=min(len(tok.encode(text[idx])), sp.max_words - 1))
            row = [sp.bos_id, *ids.tolist(), sp.eos_id]
            words[i, :len(row)] = row
        out.append({**{k: np.asarray(batch[k]) for k in ("cur_row", "view", "teacher",
                                                          "active")}, "words": words})
    return out


def make_speaker(spk, runtime, tok, device, **kw):
    from visitron_torch.agents.speaker import SpeakerAgent

    return SpeakerAgent(
        runtime=runtime, feature_dim=spk["feat"], vocab_size=len(tok),
        bos_id=tok.vocab[tok.cls_token], eos_id=tok.vocab[tok.sep_token],
        pad_id=tok.pad_token_id, episode_len=spk["episode_len"], max_words=spk["max_words"],
        hidden_size=spk["rnn"], wemb=spk["wemb"], learning_rate=1e-4, seed=SEED,
        **{"feat_dropout": 0.6, "movement_frame": True, "device": device, **kw})


def phase_speaker(device, spk, sl) -> dict:
    """27. The speaker at speaker.json's width on bench.py's synthetic world
    (phase 10's): train steps (2 warm-up, 8 timed by CUDA events), launches
    of K1-K5 (none), the idle share, peak memory; a greedy generation batch
    (ms, no synchronising call inside the decode loop, augment's read-backs
    per batch); then fp32 card vs CPU: one step with the dropouts at 0, and
    greedy tokens up to the first near tie."""
    say(f"speaker: SpeakerAgent train step and generation (batch {spk['batch']}, "
        f"{spk['episode_len']}-step trusted-path trajectories, {spk['max_words']} words, "
        f"rnn {spk['rnn']}, wemb {spk['wemb']}, {spk['feat']} + 4 features, vocabulary "
        f"{spk['vocab']}, feature dropout 0.6, movement frame)")
    t_phase = time.perf_counter()
    tok = speaker_tokenizer(spk["vocab"])
    sp = make_speaker(spk, sl["runtime"], tok, device)
    batches = speaker_batches(sp, sl["train_instances"], tok, 10, spk["batch"], SEED)
    step = sp.train_step_fn()
    state = sp.init_state()
    start = [t.clone() for t in tree_leaves(state["params"])]
    losses = []
    for batch in batches[:2]:
        state, loss = step(state, batch)
        losses.append(loss)
    sync()
    if not REHEARSAL:
        torch.cuda.reset_peak_memory_stats()
    zero_counts()
    ms = []
    for batch in batches[2:]:
        if REHEARSAL:
            t0 = time.perf_counter()
            state, loss = step(state, batch)
            ms.append((time.perf_counter() - t0) * 1e3)
        else:
            begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)
            begin.record()
            state, loss = step(state, batch)
            end.record()
            torch.cuda.synchronize()
            ms.append(begin.elapsed_time(end))
        losses.append(loss)
    counts = read_counts()
    peak = None if REHEARSAL else torch.cuda.max_memory_allocated()
    losses = torch.stack(losses).float().cpu()
    final = tree_leaves(state["params"])
    moved = sum(not torch.equal(a, b) for a, b in zip(start, final))
    med = float(np.median(ms))
    say(f"  losses {', '.join(f'{x:.4f}' for x in losses.tolist())}; {moved} of "
        f"{len(final)} parameter tensors changed")
    say(f"  {med:.2f} ms/step (CUDA events, median of {len(ms)}, range {min(ms):.2f}-"
        f"{max(ms):.2f}); peak device memory "
        f"{'n/a' if peak is None else f'{peak / 2 ** 30:.2f} GiB'}; launches in the "
        f"{len(ms)} steps {counts}")
    if not torch.isfinite(losses).all() or moved != len(final):
        fail("speaker: non-finite losses or unmoved parameters")
    if any(counts.values()):
        fail(f"speaker: a train step launched a ported kernel: {counts}")
    out = {"ms": med, "peak": peak, "counts": counts}
    if not REHEARSAL:
        holder = {"state": state}

        def one_step():
            holder["state"], _ = step(holder["state"], batches[-1])

        out["idle"] = profile_device(one_step, "speaker train step")
        state = holder["state"]

    # Generation: greedy at max_words, one walk batch.
    params = state["params"]
    arrays = sp.walk_arrays(sp.sample_walks(np.random.default_rng(SEED + 1), spk["batch"]))
    gen = sp.generate_fn(0.0)
    gen(params, arrays)
    gen_ms = []
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        ids = gen(params, arrays)
        sync()
        gen_ms.append((time.perf_counter() - t0) * 1e3)
    with torch.no_grad():
        ctx, ctx_mask = sp.encode_traj(params, sp.device_batch(arrays))
    generator = torch.Generator(device=sp.device).manual_seed(SEED)
    sync()
    if not REHEARSAL:
        torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            loops = [sp.decode_loop(params, ctx, ctx_mask, t, generator) for t in (0.0, 1.0)]
    finally:
        if not REHEARSAL:
            torch.cuda.set_sync_debug_mode(0)
    if not torch.equal(loops[0], ids):
        fail("speaker: the greedy decode loop differs from generate_fn's")
    reads = sp.readbacks
    t0 = time.perf_counter()
    records = sp.augment(params, tok, np.random.default_rng(SEED), n=spk["batch"],
                         batch_size=spk["batch"])
    aug_ms = (time.perf_counter() - t0) * 1e3
    per_batch = sp.readbacks - reads
    say(f"  greedy generation of {spk['batch']} walks x {spk['max_words']} words: "
        f"{np.median(gen_ms):.2f} ms a batch (host clock around a sync, median of 3); "
        f"the greedy and sampled decode loops ran under "
        f"torch.cuda.set_sync_debug_mode('error') "
        + ("(not on the CPU)" if REHEARSAL else "without a synchronising call")
        + f"; augment: {len(records)} records of one batch in {aug_ms:.1f} ms, "
        f"{per_batch} read-back(s) a batch")
    if per_batch != 1 or len(records) != spk["batch"]:
        fail(f"augment: {per_batch} read-backs, {len(records)} records of one batch")
    out.update(gen_ms=float(np.median(gen_ms)), aug_ms=aug_ms)
    speaker_agreement(device, spk, sl, tok)
    say(f"  phase {time.perf_counter() - t_phase:.1f} s")
    return out


def speaker_agreement(device, spk, sl, tok) -> None:
    """fp32 with the dropouts at 0, card against CPU: one train step on an
    ``agree``-item batch (loss, gradients, also relative to the largest,
    and the Adam update), then the greedy tokens of 4 x ``agree`` walks,
    compared up to each row's end or its first earlier step whose top-2
    logit margin on the CPU is below GREEDY_MARGIN."""
    from torch.func import functional_call

    n = spk["agree"]
    say(f"speaker agreement: fp32, dropouts 0, card vs CPU on {n} items and "
        f"{4 * n} walks")
    agents = {}
    for dev in (device, "cpu"):
        rt = NavRuntime.build(sl["world"].graphs, sl["table"], device_dtype=torch.float32,
                              device=dev)
        agents[dev] = make_speaker(spk, rt, tok, dev, dropout=0.0, feat_dropout=0.0)
    batch = speaker_batches(agents["cpu"], sl["train_instances"], tok, 1, n, SEED + 3)[0]
    out, ids = {}, {}
    n_walks = 4 * n
    arrays = agents["cpu"].walk_arrays(agents["cpu"].sample_walks(
        np.random.default_rng(SEED + 4), n_walks))
    for dev, sp in agents.items():
        state = sp.init_state()
        loss, _, grads = sp.value_and_grads(
            state["params"], lambda p: (sp.loss(p, sp.device_batch(batch)), None))
        new, _ = sp.train_step_fn()(state, batch)
        out[dev] = step_record(loss, grads, state, new)
        ids[dev] = sp.generate_fn(0.0)(state["params"], arrays).cpu()
    check_step_agreement(device, out, 1e-4)
    # The random-weight gradients are small beside AGREE_TOL's atol: their
    # error is held to 1e-3 of the largest, too.
    g_card, g_cpu = out[device][1].cpu(), out["cpu"][1]
    rel = float((g_card - g_cpu).abs().max() / g_cpu.abs().max())
    say(f"  gradients: max|card - cpu| / max|g| {rel:.3g} (tolerance 1e-3; max|g| "
        f"{float(g_cpu.abs().max()):.3g})")
    if rel > 1e-3:
        fail("speaker: gradients disagree between the card and the CPU")
    sp = agents["cpu"]
    params = sp.init_params()
    with torch.no_grad():
        ctx, mask = sp.encode_traj(params, sp.device_batch(arrays))
        words = torch.cat([torch.full((n_walks, 1), sp.bos_id), ids["cpu"][:, :-1]], 1)
        h0 = torch.zeros((n_walks, sp.hidden_size))
        logits = functional_call(sp.decoder, params["decoder"], (words, ctx, mask, h0, h0))[0]
    top2 = logits.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    walks_tied, near, steps, compared = 0, 0, 0, 0
    for row in range(n_walks):
        # After EOS both emit padding, whatever the logits.
        ended = torch.nonzero(ids["cpu"][row] == sp.eos_id).flatten()
        end = int(ended[0]) + 1 if len(ended) else sp.max_words
        ties = torch.nonzero(margin[row, :end] < GREEDY_MARGIN).flatten()
        stop = int(ties[0]) if len(ties) else end
        walks_tied += len(ties) > 0
        near, steps, compared = near + len(ties), steps + end, compared + stop
        if not torch.equal(ids[device][row, :stop], ids["cpu"][row, :stop]):
            fail(f"speaker: greedy tokens of walk {row} differ card vs CPU before a near tie")
    say(f"  greedy tokens: {compared} of the {steps} decode steps before EOS compared, "
        f"equal card vs CPU; {walks_tied} of {n_walks} walks reach a top-2 margin below "
        f"{GREEDY_MARGIN:g} ({near} such steps)")
    # At random weights a walk's greedy decode settles into a repeated word
    # whose state converges, so near ties cluster after a walk's first one
    # (chip runs: 1 of 4 and 4 of 16 walks reached one).  The comparison
    # must still cover most of the decode.
    if compared < 0.5 * steps:
        fail(f"speaker: only {compared} of {steps} greedy steps compared before near ties")


def phase_speaker_cli(device, tmp: str, cli: dict) -> dict:
    """28. The back-translation chain through ``run.main`` on the --debug
    world, the configs cut only in iterations and num_aug: ``run speaker``
    (speaker.json) 4 iterations, --resume to 6; ``run augment``
    (augment.json, --aug_targets, num_aug 64) from its checkpoint; ``run
    viewpoint --aug_data`` (ndh_oscar_setting.json) 2 iterations: the train
    split grows by num_aug, launches per iteration as phase 22's."""
    import dataclasses

    from visitron_torch.config import RunConfig
    from visitron_torch.train.checkpoint import CheckpointManager
    from visitron_torch.train.finetune import viewpoint_instances
    from visitron_torch.train.logging import setup_logger
    from visitron_torch.train.workspace import Workspace

    say("speaker chain: run speaker -> run augment -> run viewpoint --aug_data on the "
        "--debug world")
    t_phase = time.perf_counter()
    num_aug = 64
    scale = ["--max_words", "12"] if REHEARSAL else []
    out = {}
    spk = os.path.join(tmp, "speaker")
    args = ["speaker", "--config", SPEAKER_CONFIG, "--debug", "--logging_steps", "1",
            "--saving_steps", "2", "--output_dir", spk] + scale
    with BoundaryHooks() as hooks:
        rows = hooks.run(args + ["--num_iterations", "4"], device)
        ms = [r[1] for r in rows[1:]]
        out["ms"] = float(np.median(ms))
        say(f"  speaker, 4 iterations (batch 32, 40-step trajectories, 80 words): ms per "
            f"iteration {', '.join(f'{m:.1f}' for m in ms)} (the first, with set-up, "
            f"{rows[0][1]:.1f}); median {out['ms']:.1f}, {out['ms'] / cli['vp_ms']:.2f}x "
            f"phase 22's viewpoint iteration ({cli['vp_ms']:.1f})")
        out["counts"] = check_iteration_launches("speaker", rows, CLI_SPEAKER)
        rows = hooks.run(args + ["--num_iterations", "6", "--resume"], device)
        mgr = CheckpointManager(spk)
        resumed = [r[0] for r in rows]
        count = mgr.restore_raw(6, "opt_state")[0]["count"]
        say(f"  resume: checkpoints {mgr.steps()}, the resumed run's iterations {resumed}, "
            f"Adam count at checkpoint-6 {count}")
        if mgr.steps() != [2, 4, 6] or resumed != [5, 6] or count != 6:
            fail("speaker: resume did not continue from checkpoint-4 to 6")
        check_iteration_launches("speaker, resumed", rows, CLI_SPEAKER)

        aug = os.path.join(tmp, "augment")
        t0 = time.perf_counter()
        hooks.run(["augment", "--config", AUGMENT_CONFIG, "--debug", "--speaker_checkpoint",
                   spk, "--num_aug", str(num_aug), "--output_dir", aug] + scale, device)
        out["augment_ms"] = (time.perf_counter() - t0) * 1e3
        aug_file = os.path.join(aug, "aug_data.json")
        records = json.load(open(aug_file))
        say(f"  augment: {len(records)} records in {out['augment_ms']:.0f} ms (set-up "
            f"included), targets {sorted({r['target'] for r in records})[:4]}..., first "
            f"caption {records[0]['instructions'][0][:60]!r}")
        if len(records) != num_aug or not all(r.get("target") and r["instructions"][0]
                                              for r in records):
            fail(f"augment: {len(records)} records, or some without a target or caption")

        nav = os.path.join(tmp, "viewpoint_aug")
        vp_args = ["viewpoint", "--config", FINETUNE_CONFIG, "--debug", "--aug_data",
                   aug_file, "--num_iterations", "2", "--saving_steps", "2",
                   "--logging_steps", "1", "--eval_iters", "2", "--output_dir", nav]
        rows = hooks.run(vp_args + (REHEARSAL_SEQ if REHEARSAL else []), device)
        out["vp_ms"] = rows[-1][1]
        out["vp_counts"] = check_iteration_launches("viewpoint --aug_data", rows,
                                                    CLI_FINETUNE)
    cfg = dataclasses.replace(RunConfig.from_json(FINETUNE_CONFIG), debug=True,
                              output_dir=nav)
    ws = Workspace.synthetic_workspace(cfg, device="cpu")
    logger = setup_logger(output_dir=nav)
    base = len(viewpoint_instances(cfg, ws, ["train"], logger))
    grown = len(viewpoint_instances(dataclasses.replace(cfg, aug_data=aug_file), ws,
                                    ["train"], logger))
    say(f"  viewpoint --aug_data, 2 iterations: the train split {base} -> {grown} "
        f"instances; ms of iteration 2 {out['vp_ms']:.1f} beside phase 22's "
        f"{cli['vp_ms']:.1f}; checkpoints {CheckpointManager(nav).steps()}")
    if grown != base + num_aug or CheckpointManager(nav).steps() != [2]:
        fail(f"--aug_data: the train split grew by {grown - base}, not {num_aug}")
    say(f"  phase {time.perf_counter() - t_phase:.1f} s")
    return out


# -- phases 29-32: the model options no caller sets, the offline feature pipelines -------

# Launches per iteration of `run viewpoint --no_use_fused_layernorm`: the
# attention kernels as phase 22's, no LayerNorm kernel.
CLI_NO_FUSED_LN = {"K1f": 12, "K1b": 12}
# Card vs CPU in fp32 through ResNet-152 (scene) and the ResNet-101 detector:
# summation order over 50-150 convolutions (no TF32), relative to the largest
# value.  Probabilities: absolute.
FEATURE_AGREE = 1e-3
PROB_AGREE = 1e-4
# Kept proposals are compared card vs CPU up to the first pick whose score
# is within this of the next one's (a near tie may pick in either order).
NMS_MARGIN = 1e-5


def feature_launches(what: str) -> dict:
    """Launches of every kernel since the last zero_counts(), printed; a
    feature path launches none of K1-K5."""
    counts = read_counts()
    say(f"  launches of K1-K5 in {what}: {sum(counts.values())}")
    if any(counts.values()):
        fail(f"{what} launched {counts}")
    return counts


def peak_gib() -> float:
    return 0.0 if REHEARSAL else torch.cuda.max_memory_allocated() / 2 ** 30


def reset_peak() -> None:
    if not REHEARSAL:
        torch.cuda.reset_peak_memory_stats()


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|."""
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def phase_options(device, opt) -> dict:
    """29. History K/V and the bidirectional LSTM (the --no_use_fused_layernorm
    CLI run is phase_no_fused_ln_cli)."""
    from visitron_torch.models import OscarEncoder, VisitronBert
    from visitron_torch.models.layers import init_module_params

    b, q, p = opt["batch"], opt["fresh"], opt["history"]
    cfg = BertConfig(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                     dtype=opt["dtype"], **opt["bert"])
    say(f"options: VisitronBert with history K/V ({cfg.num_hidden_layers} layers, "
        f"hidden {cfg.hidden_size}, {cfg.num_attention_heads} heads, batch {b}, {q} fresh "
        f"tokens over {p} history tokens a layer, {str(cfg.dtype).split('.')[-1]})")
    t_phase = time.perf_counter()
    g = np.random.default_rng(SEED)
    ids = g.integers(0, cfg.vocab_size, (b, q))
    mask = (np.arange(q)[None] < g.integers(q // 2, q + 1, (b, 1))).astype(np.int64)
    hist = g.standard_normal((cfg.num_hidden_layers, b, p, cfg.hidden_size)).astype(np.float32)
    sd = init_module_params(VisitronBert(cfg, image=False), torch.Generator().manual_seed(SEED))

    def run(dtype, dev, n):
        model = VisitronBert(cfg.replace(dtype=dtype), image=False).to(dev)
        params = {k: v.to(dev) for k, v in sd.items()}
        args = (torch.as_tensor(ids[:n], device=dev),)
        kw = {"attention_mask": torch.as_tensor(mask[:n], device=dev),
              "history_states": torch.as_tensor(hist[:, :n], device=dev).to(dtype)}
        return lambda: functional_call(model, params, args, kw)

    fwd = run(cfg.dtype, device, b)
    with torch.inference_mode():
        zero_counts()
        seq, pooled = fwd()
        sync()
        counts = read_counts()
        ms = time_ms(fwd, iters=10, warmup=2)
    want = {k: 0 for k in COUNTED}
    want["K2f"] = 2 * cfg.num_hidden_layers + 1
    say(f"  forward: {ms:.2f} ms (CUDA events, mean of 10); launches K2f {counts['K2f']}, "
        f"K1f {counts['K1f']} (every layer takes the plain attention over {p + q} keys)")
    if (not REHEARSAL and counts != want) or not (torch.isfinite(seq).all()
                                                  and torch.isfinite(pooled).all()):
        fail(f"history K/V forward: launches {counts} (expected {want}), or non-finite")
    n = opt["agree"]
    with torch.inference_mode():
        card, cpu = run(torch.float32, device, n)(), run(torch.float32, "cpu", n)()
    for name, got, ref in zip(("sequence", "pooled"), card, cpu):
        err = check_close(f"history K/V fp32 {name}, card vs CPU", got.cpu(), ref, AGREE_TOL)
        say(f"  history K/V fp32 {name} ({n} items), card vs CPU: max error {err:.3e}")

    ecfg = cfg.replace(dtype=torch.float32, max_position_embeddings=q)
    enc_sd = init_module_params(OscarEncoder(ecfg, bidirectional=True),
                                torch.Generator().manual_seed(SEED + 1))
    lengths = np.array([q, q // 3] + [q // 2] * (n - 2))[:n]
    outs = {}
    for dev in (device, "cpu"):
        enc = OscarEncoder(ecfg, bidirectional=True).to(dev)
        with torch.inference_mode():
            outs[dev] = functional_call(enc, {k: v.to(dev) for k, v in enc_sd.items()},
                                        (torch.as_tensor(ids[:n], device=dev),
                                         torch.as_tensor(lengths, device=dev)))
    for name, got, ref in zip(("ctx", "h0", "c0"), outs[device], outs["cpu"]):
        err = check_close(f"bidirectional OscarEncoder {name}", got.cpu(), ref, AGREE_TOL)
        say(f"  bidirectional OscarEncoder {name} {tuple(ref.shape)} fp32, card vs CPU: "
            f"max error {err:.3e}")
    if outs["cpu"][0][1, lengths[1]:].abs().max() != 0 or \
            outs[device][0][1, lengths[1]:].abs().max() != 0:
        fail("bidirectional LSTM: outputs at pads not zero")
    say(f"  phase {time.perf_counter() - t_phase:.1f} s")
    return {"counts": counts, "ms": ms}


def phase_no_fused_ln_cli(device, tmp: str, cli: dict) -> dict:
    """29 (CLI). ``run viewpoint --debug --no_use_fused_layernorm`` for 2
    iterations (phase 22's config and world): launches per iteration, ms
    beside phase 22's viewpoint iteration."""
    say("options: run viewpoint --debug --no_use_fused_layernorm, 2 iterations")
    with BoundaryHooks() as hooks:
        rows = hooks.run(["viewpoint", "--config",
                          "run_configs/viewpoint_train/ndh_oscar_setting.json", "--debug",
                          "--no_use_fused_layernorm", "--num_iterations", "2",
                          "--saving_steps", "2", "--logging_steps", "1", "--eval_iters", "2",
                          "--output_dir", os.path.join(tmp, "no_fused_ln")]
                         + (REHEARSAL_SEQ if REHEARSAL else []), device)
    counts = check_iteration_launches("viewpoint --no_use_fused_layernorm", rows,
                                      CLI_NO_FUSED_LN)
    ms = rows[-1][1]
    say(f"  ms of iteration 2: {ms:.1f}, phase 22's viewpoint iteration {cli['vp_ms']:.1f} "
        f"({ms / cli['vp_ms']:.2f}x)")
    return {"counts": counts, "ms": ms}


def conv_flops(model, images) -> int:
    """FLOPs (2 a multiply-add) of the convolutions of one image, from the
    shapes a forward hook sees."""
    total = [0]

    def hook(mod, _, out):
        k = mod.kernel_size[0] * mod.kernel_size[1] * mod.in_channels // mod.groups
        total[0] += 2 * k * out[0].numel()

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, torch.nn.Conv2d)]
    with torch.inference_mode():
        model(images[:1])
    for h in hooks:
        h.remove()
    return total[0]


def phase_scene(device, sc) -> dict:
    """30. The scene extractor in faces mode at its production geometry:
    frames/s, idle share, peak memory, FLOP share, bf16 drift, fp32 card vs
    CPU."""
    from visitron_torch.models.resnet import ResNet, random_state
    from visitron_torch.pipelines.scene_features import SceneFeatureExtractor

    n_views = sc["panos"] * geo.NUM_VIEWS
    say(f"scene features: ResNet-{sc['depth']} at {sc['w']}x{sc['h']}, VFOV {sc['vfov']}, "
        f"faces mode ({sc['face']} px uint8 faces), {sc['panos']} panoramas ({n_views} "
        "views) a forward, bf16 and fp32")
    t_phase = time.perf_counter()
    state = random_state(ResNet(sc["depth"]), SEED)
    faces = np.random.default_rng(SEED).integers(
        0, 256, (sc["panos"], 6, sc["face"], sc["face"], 3), dtype=np.uint8)
    out, feats = {}, {}
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[-1]
        ex = SceneFeatureExtractor(state=state, depth=sc["depth"], image_w=sc["w"],
                                   image_h=sc["h"], vfov=sc["vfov"],
                                   viewpoints_per_batch=sc["panos"], dtype=dt, device=device)
        reset_peak()
        zero_counts()
        feats[dt] = ex.forward_faces(faces)
        counts = feature_launches(f"a {name} scene forward")
        ms = time_ms(lambda: ex.forward_faces(faces), iters=sc["iters"], warmup=1)
        peak = peak_gib()
        idle = None if REHEARSAL else profile_device(lambda: ex.forward_faces(faces),
                                                     f"{name} scene forward")
        views = ex._lut.render_torch(torch.as_tensor(faces[:1], device=device), dtype=dt)[0]
        flops = conv_flops(ex.model, views)
        share = flops * n_views / (ms / 1e3) / PEAK_OPS_PER_S[dt]
        say(f"  {name}: {ms:.2f} ms a forward of {n_views} views (CUDA events, mean of "
            f"{sc['iters']}), {n_views / ms * 1e3:.1f} frames/s; conv {flops / 1e9:.2f} "
            f"GFLOP a view, {share:.1%} of {PEAK_OPS_PER_S[dt] / 1e12:.0f} TFLOP/s; peak "
            f"{peak:.2f} GiB")
        if feats[dt].shape != (n_views, 2048) or not np.isfinite(feats[dt]).all():
            fail(f"scene features {feats[dt].shape}, or non-finite")
        out[name] = {"ms": ms, "fps": n_views / ms * 1e3, "idle": idle, "peak_gib": peak,
                     "gflop_per_view": flops / 1e9, "flop_share": share, "counts": counts}
        if dt == torch.float32:
            with torch.inference_mode():
                card = ex.model(views[:sc["agree_views"]])
            cpu_model = ResNet(sc["depth"])
            cpu_model.load_state_dict(ex.model.state_dict())
            with torch.inference_mode():
                ref = cpu_model(views[:sc["agree_views"]].cpu())
            err = rel_err(card, ref)
            say(f"  fp32 card vs CPU ({sc['agree_views']} views): max error {err:.3e} of "
                f"the largest feature (limit {FEATURE_AGREE})")
            if err > FEATURE_AGREE:
                fail("scene features: fp32 card and CPU disagree")
            out["agree"] = err
    bf, f32 = feats[torch.bfloat16], feats[torch.float32]
    drift = np.linalg.norm(bf - f32, axis=1) / np.linalg.norm(f32, axis=1)
    say(f"  bf16 vs fp32 features: relative L2 drift mean {drift.mean():.3e}, max "
        f"{drift.max():.3e}")
    out["drift"] = {"mean": float(drift.mean()), "max": float(drift.max())}
    say(f"  phase {time.perf_counter() - t_phase:.1f} s")
    return out


def caffe_dump(depth: int, classes: int, attrs: int, seed: int) -> dict:
    """Random weights in the bottom-up caffe dump layout
    (models/detector.py:convert_caffe_bottomup) from ``seed``, with
    tests/test_detector_torch_parity.py's distributions.  At 600 px every
    proposal of this detector grows to the whole image and NMS keeps one
    ROI a view (see spread_proposals)."""
    from visitron_torch.models.detector import _caffe_stage_names
    from visitron_torch.models.resnet import STAGE_BLOCKS

    rng = np.random.default_rng(seed)
    s: dict = {}

    def conv(name, cout, cin, k, bias=False):
        s[name + ".weight"] = (rng.standard_normal((cout, cin, k, k), np.float32)
                               / np.float32(np.sqrt(cin * k * k)))
        if bias:
            s[name + ".bias"] = rng.normal(0, 0.02, cout).astype(np.float32)

    def bn(cname, c):
        s[f"bn{cname}.mean"] = rng.normal(0, 0.05, c).astype(np.float32)
        s[f"bn{cname}.var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        s[f"scale{cname}.weight"] = rng.uniform(0.8, 1.2, c).astype(np.float32)
        s[f"scale{cname}.bias"] = rng.normal(0, 0.05, c).astype(np.float32)

    def dense(name, cout, cin):
        s[name + ".weight"] = (rng.standard_normal((cout, cin), np.float32)
                               / np.float32(np.sqrt(cin)))
        s[name + ".bias"] = rng.normal(0, 0.02, cout).astype(np.float32)

    conv("conv1", 64, 3, 7)
    bn("_conv1", 64)
    names = _caffe_stage_names(depth)
    inplanes = 64
    for si, n in enumerate(STAGE_BLOCKS[depth]):
        width = 64 * 2 ** si
        for bi in range(n):
            cn = names[(si, bi)].removeprefix("res")
            for part, (cout, cin, k) in zip("abc", ((width, inplanes if bi == 0 else width * 4, 1),
                                                    (width, width, 3), (width * 4, width, 1))):
                conv(f"res{cn}_branch2{part}", cout, cin, k)
                bn(f"{cn}_branch2{part}", cout)
            if bi == 0:
                conv(f"res{cn}_branch1", width * 4, inplanes, 1)
                bn(f"{cn}_branch1", width * 4)
        inplanes = width * 4
    conv("rpn_conv/3x3", 512, 1024, 3, bias=True)
    conv("rpn_cls_score", 24, 512, 1, bias=True)
    conv("rpn_bbox_pred", 48, 512, 1, bias=True)
    dense("cls_score", classes, 2048)
    dense("bbox_pred", 4 * classes, 2048)
    s["cls_embedding.weight"] = rng.normal(0, 0.1, (classes, 256)).astype(np.float32)
    dense("fc_attr", 512, 2048 + 256)
    dense("attr_score", attrs, 512)
    return s


def spread_proposals(dump: dict) -> dict:
    """``dump`` with conv1 scaled for caffe's input (0-255 pixels less their
    means, ~64x the unit scale) and the RPN's box regression and objectness
    made small: the proposals spread over the image near their anchors with
    unsaturated scores, and NMS keeps its full ``num_rois``, as with trained
    weights."""
    out = dict(dump)
    for name, factor in (("conv1.weight", 1 / 64), ("rpn_bbox_pred.weight", 0.01),
                         ("rpn_cls_score.weight", 0.1)):
        out[name] = dump[name] * np.float32(factor)
    return out


def kernel_count(fn) -> int | None:
    """Device kernels one call of ``fn`` launches (torch.profiler); None
    when the profiler recorded none, or in a rehearsal."""
    if REHEARSAL:
        return None
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = len(device_kernels(prof))
    return n or None


def kept_prefix(scores: np.ndarray) -> int:
    """Picks of a (R,) NMS score list that are decided: up to the first whose
    score is within NMS_MARGIN of the next live one."""
    live = scores > np.finfo(np.float32).min / 2
    n = int(live.sum())
    gaps = np.where(scores[:n - 1] - scores[1:n] < NMS_MARGIN)[0]
    return int(gaps[0]) + 1 if len(gaps) else n


def phase_regions(device, rg) -> dict:
    """31. The bottom-up detector at its production configuration: frames/s,
    idle share, peak memory, nms_fixed's ms and launches a dispatch (and no
    synchronising call in it), fp32 card vs CPU on one view."""
    from visitron_torch.models.detector import BottomUpDetector, nms_fixed
    from visitron_torch.pipelines.region_features import RegionFeatureExtractor

    per = rg["per_dispatch"]
    say(f"region features: FasterRCNN ResNet-{rg['depth']} from a seeded caffe-layout dump "
        f"({rg['classes']} classes, {rg['attrs']} attributes, {rg['rois']} ROIs, pre-NMS "
        f"{rg['pre_nms']}), {rg['side']}x{rg['side']} at VFOV {rg['vfov']}, {per} views a "
        f"dispatch, fp32 and bf16")
    t_phase = time.perf_counter()
    dump = spread_proposals(caffe_dump(rg["depth"], rg["classes"], rg["attrs"], SEED))
    faces = np.random.default_rng(SEED + 1).integers(
        0, 256, (6, rg["face"], rg["face"], 3), dtype=np.uint8)
    kw = dict(depth=rg["depth"], num_classes=rg["classes"], num_attributes=rg["attrs"],
              num_rois=rg["rois"], pre_nms_top_n=rg["pre_nms"])
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[-1]
        det = BottomUpDetector.from_caffe_dump(dump, dtype=dt, device=device, **kw)
        ex = RegionFeatureExtractor(det, [f"c{i}" for i in range(rg["classes"])],
                                    [f"a{i}" for i in range(rg["attrs"])],
                                    image_w=rg["side"], image_h=rg["side"], vfov=rg["vfov"])
        views = ex.render(faces)
        batches = [views[s:s + per] for s in range(0, geo.NUM_VIEWS, per)][:rg["dispatches"]]
        n_views = per * len(batches)
        reset_peak()
        zero_counts()
        raws = det.detect_batch(batches[0])
        counts = feature_launches(f"a {name} detector dispatch")
        ms = time_ms(lambda: [det.detect_batch(b) for b in batches], iters=2, warmup=1)
        peak = peak_gib()
        idle = None if REHEARSAL else profile_device(lambda: det.detect_batch(batches[0]),
                                                     f"{name} detector dispatch")
        live = [len(r["boxes"]) for r in raws]
        t0 = time.perf_counter()
        ex._postprocess(raws[0], geo.heading_of_view(0), geo.elevation_of_view(0))
        post_s = time.perf_counter() - t0
        with torch.inference_mode():
            feat = det.model.body(batches[0])
            boxes, scores = det.model.proposals(feat, rg["side"], rg["side"])
            nms = lambda: nms_fixed(boxes, scores, det.model.nms_thresh, rg["rois"])  # noqa: E731
            nms_ms = time_ms(nms, iters=5, warmup=1)
            launches = kernel_count(nms)
            sync()
            if not REHEARSAL:
                torch.cuda.set_sync_debug_mode("error")
            try:
                nms()
            finally:
                if not REHEARSAL:
                    torch.cuda.set_sync_debug_mode(0)
        say(f"  {name}: {ms / len(batches):.2f} ms a dispatch of {per} views ({n_views} views "
            f"in {ms:.2f} ms, CUDA events), {n_views / ms * 1e3:.1f} frames/s; live ROIs a "
            f"view {min(live)}-{max(live)}; peak {peak:.2f} GiB; nms_fixed {nms_ms:.2f} ms a "
            f"dispatch ({per} x {boxes.shape[1]} proposals, {rg['rois']} picks), "
            f"{launches} launches, no synchronising call; the host's post-processing "
            f"(ops/detection.py: per-class NMS over {rg['classes'] - 1} classes, dedup, "
            f"tokens) {post_s:.2f} s for one view of {live[0]} live ROIs")
        if any(not np.isfinite(r["features"]).all() for r in raws) or \
                min(live) < rg["rois"] // 2:
            fail(f"detector: non-finite features, or views with {min(live)} live ROIs")
        out[name] = {"ms_dispatch": ms / len(batches), "fps": n_views / ms * 1e3,
                     "idle": idle, "peak_gib": peak, "nms_ms": nms_ms,
                     "nms_launches": launches, "counts": counts, "live": live,
                     "post_s_per_view": post_s}
        if dt == torch.float32:
            out["agree"] = region_agreement(det, dump, kw, views[:1])
    say(f"  phase {time.perf_counter() - t_phase:.1f} s")
    return out


def region_agreement(det, dump, kw, view) -> dict:
    """fp32 card vs CPU on one view: the kept proposals equal up to the first
    near tie (NMS_MARGIN) of the CPU's scores, features and probabilities of
    those rows within FEATURE_AGREE / PROB_AGREE."""
    from visitron_torch.models.detector import BottomUpDetector

    cpu = BottomUpDetector.from_caffe_dump(dump, device="cpu", **kw)
    with torch.inference_mode():
        card = {k: v[0].cpu() for k, v in det.model(view).items()}
        ref = {k: v[0] for k, v in cpu.model(view.cpu()).items()}
    n = kept_prefix(ref["scores"].numpy())
    live = int((ref["scores"] > np.finfo(np.float32).min / 2).sum())
    errs = {"boxes": rel_err(card["boxes"][:n], ref["boxes"][:n]) if n else 0.0,
            "features": rel_err(card["features"][:n], ref["features"][:n]) if n else 0.0}
    for k in ("cls_prob", "attr_prob"):
        errs[k] = float((card[k][:n] - ref[k][:n]).abs().max()) if n else 0.0
    say(f"  fp32 card vs CPU (1 view): {n} of {live} live picks before the first score "
        f"margin below {NMS_MARGIN}; their boxes within {errs['boxes']:.2e} of the "
        f"largest coordinate, features {errs['features']:.2e} of the largest, cls_prob "
        f"{errs['cls_prob']:.2e}, attr_prob {errs['attr_prob']:.2e}")
    if n == 0 or errs["boxes"] > 1e-5 or errs["features"] > FEATURE_AGREE \
            or max(errs["cls_prob"], errs["attr_prob"]) > PROB_AGREE:
        fail("detector: fp32 card and CPU disagree")
    return {"picks_compared": n, "live": live, **errs}


def write_skyboxes(root: str, scan: str, vps, face: int, seed: int) -> None:
    """Matterport-layout skybox JPEGs of seeded uint8 faces under ``root``."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    d = os.path.join(root, scan, "matterport_skybox_images")
    os.makedirs(d)
    for vp in vps:
        for i in range(6):
            Image.fromarray(rng.integers(0, 256, (face, face, 3), dtype=np.uint8)).save(
                os.path.join(d, f"{vp}_skybox{i}_sami.jpg"), quality=95)


def phase_extract_cli(device, tmp: str, ec) -> dict:
    """32. ``run extract_scene`` with a seeded torchvision-layout ResNet-152
    .pth and ``run extract_regions`` with a seeded .npz caffe dump and
    1601 / 401-line vocabularies, over a 2-viewpoint scan of 1024 px skybox
    faces at full geometry: the TSV read back, verify_region_store, no K1-K5
    launch, ms a viewpoint."""
    from visitron_torch import run as cli
    from visitron_torch.data.features import read_tsv_img_features
    from visitron_torch.models.resnet import ResNet, random_state
    from visitron_torch.pipelines.region_features import verify_region_store

    say("extract CLI: run extract_scene and run extract_regions over a 2-viewpoint scan"
        + (" (--debug geometry: random ResNet-50, StubDetector)" if REHEARSAL else
           f" ({ec['face']} px faces, ResNet-{ec['depth']} .pth, ResNet-101 detector .npz)"))
    t_phase = time.perf_counter()
    root = os.path.join(tmp, "extract")
    conn = os.path.join(root, "conn")
    os.makedirs(conn)
    entries = [{"image_id": vp, "pose": [1, 0, 0, 2.0 * i, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1],
                "included": True, "unobstructed": [j != i for j in range(2)], "height": 1.5}
               for i, vp in enumerate(("vpA", "vpB"))]
    with open(os.path.join(conn, "sc1_connectivity.json"), "w") as f:
        json.dump(entries, f)
    write_skyboxes(os.path.join(root, "mp"), "sc1", ("vpA", "vpB"), ec["face"], SEED)
    out = os.path.join(root, "out")
    args = ["--connectivity_dir", conn, "--matterport_dir", os.path.join(root, "mp"),
            "--output_dir", out, "--img_feature_file", os.path.join(out, "scene.tsv"),
            "--region_feature_prefix", os.path.join(out, "regions")]
    if REHEARSAL:
        args = ["--debug"] + args
    else:
        pth = os.path.join(root, "resnet152.pth")
        torch.save(random_state(ResNet(ec["depth"]), SEED), pth)
        npz = os.path.join(root, "detector.npz")
        np.savez(npz, **caffe_dump(101, 1601, 401, SEED))
        for name, n, prefix in (("objects", 1601, "obj"), ("attributes", 401, "attr")):
            with open(os.path.join(root, f"{name}.txt"), "w") as f:
                f.write("\n".join(["__background__" if name == "objects" else
                                   "__no_attribute__"] + [f"{prefix}{i}" for i in range(n - 1)]))
        args += ["--resnet_checkpoint", pth, "--detector_weights", npz,
                 "--objects_vocab", os.path.join(root, "objects.txt"),
                 "--attributes_vocab", os.path.join(root, "attributes.txt")]
    os.makedirs(out)
    res = {}
    for task in ("extract_scene", "extract_regions"):
        zero_counts()
        t0 = time.perf_counter()
        cli.main([task] + args, device=device)
        res[task] = {"ms_per_viewpoint": (time.perf_counter() - t0) * 1e3 / 2,
                     "counts": feature_launches(f"run {task}")}
    tsv = read_tsv_img_features(os.path.join(out, "scene.tsv"), 2048)
    shapes = {k: v.shape for k, v in tsv["features"].items()}
    say(f"  extract_scene: {res['extract_scene']['ms_per_viewpoint']:.1f} ms a viewpoint "
        f"with set-up; TSV read back {shapes}, {tsv['image_w']}x{tsv['image_h']} VFOV "
        f"{tsv['vfov']}")
    if shapes != {"sc1_vpA": (36, 2048), "sc1_vpB": (36, 2048)} or not all(
            np.isfinite(v).all() for v in tsv["features"].values()):
        fail(f"extract_scene TSV {shapes}, or non-finite")
    ver = verify_region_store(os.path.join(out, "regions"))
    say(f"  extract_regions: {res['extract_regions']['ms_per_viewpoint']:.1f} ms a viewpoint "
        f"with set-up; verify_region_store {ver}" + ("" if REHEARSAL else
        " (this seeded dump keeps one ROI a view, see caffe_dump: phase 31 times the "
        "host's post-processing of a full view)"))
    if ver["num_keys"] != 72 or ver["feature_dim"] != 2054:
        fail(f"extract_regions store {ver}")
    say(f"  phase {time.perf_counter() - t_phase:.1f} s")
    return res


# -- phase 12: pretrain --------------------------------------------------------------

def pretrain_batch(rng, sizes, vocab, img_dim, classes):
    """A copy of tools/bench_pretrain.py:_batch (joint text + image sequence,
    15% MLM labels, next-action labels) that also sets region-token labels
    on 5% of the text positions, and masks the last ``img_pad`` region slots
    (the bucket's padding, as a PretrainDataset batch has it)."""
    batch, seq, img = sizes["batch"], sizes["text"], sizes["img"]
    tokens = np.where(rng.random((batch, seq + img)) < 0.05,
                      rng.integers(0, classes, (batch, seq + img)), -1).astype(np.int32)
    tokens[:, seq:] = -1
    mask = np.ones((batch, seq + img), np.int32)
    mask[:, seq + img - sizes.get("img_pad", 0):] = 0
    return {
        "input_ids": rng.integers(0, vocab, (batch, seq)).astype(np.int32),
        "token_type_ids": rng.integers(0, 4, (batch, seq)).astype(np.int32),
        "attention_mask": mask,
        "labels": np.where(rng.random((batch, seq + img)) < 0.15,
                           rng.integers(0, vocab, (batch, seq + img)), -1).astype(np.int32),
        "token_labels": tokens,
        "img_feats": rng.standard_normal((batch, img, img_dim)).astype(np.float32),
        "img_location_embeddings": rng.standard_normal((batch, img, 128)).astype(np.float32),
        "next_action": rng.integers(0, 36, (batch,)).astype(np.int32),
    }


def pretrain_config(sizes, dtype, **kw) -> BertConfig:
    """tools/bench_pretrain.py's configuration: BERT-base, vocab 30525, 768
    positions, 4 token types, 2054-d region features."""
    return BertConfig(vocab_size=sizes["vocab"], max_position_embeddings=sizes["positions"],
                      type_vocab_size=4, dtype=dtype, **sizes["bert"], **kw)


def pretrain_flops(cfg, sizes) -> float:
    """Analytic FLOPs of one train step (forward + backward = 3x forward for
    the products; attention: 2 products forward, 5 backward)."""
    b, s_t, s_i = sizes["batch"], sizes["text"], sizes["img"]
    r, s, h = b * (s_t + s_i), s_t + s_i, cfg.hidden_size
    layers, heads, d = cfg.num_hidden_layers, cfg.num_attention_heads, h // cfg.num_attention_heads
    dense = 6 * r * layers * (4 * h * h + 2 * h * cfg.intermediate_size)
    attention = 14 * b * heads * s * s * d * layers
    heads_ = 6 * r * h * (h + cfg.vocab_size + cfg.detector_classes)
    image = 6 * b * s_i * (cfg.img_feature_dim + cfg.location_embed_dim) * h
    return float(dense + attention + heads_ + image), float(dense), float(attention), \
        float(6 * r * h * cfg.vocab_size)


ROUTE_NAMES = {"K4": "K4 ((B, H, S, D) views)", "K5": "K5 (flash, (B, H, S, D) views)"}


def phase_pretrain(device, sizes, attn: str = "K4",
                   what: str = "pretrain: the multimodal pretraining step", **cfg_kw) -> dict:
    """The pretraining step, every self-attention expected through ``attn``
    (K4 at S 768; K5 past the fused gate with ``use_flash_attention``)."""
    say(f"{what}, PretrainTrainer.step_fn")
    n_warm, n_timed = 2, sizes["steps"]
    t0 = time.perf_counter()
    cfg = pretrain_config(sizes, sizes["dtype"], **cfg_kw)
    trainer = PretrainTrainer(cfg, learning_rate=5e-5, total_steps=100, device=device)
    rng = np.random.default_rng(SEED)
    batches = [pretrain_batch(rng, sizes, cfg.vocab_size, cfg.img_feature_dim,
                              cfg.detector_classes) for _ in range(n_warm + n_timed)]
    state = trainer.init_state()
    start = [t.clone() for t in tree_leaves(state["params"])]
    step = trainer.step_fn()
    s = sizes["text"] + sizes["img"]
    say(f"  set-up {time.perf_counter() - t0:.1f} s: BERT {cfg.num_hidden_layers}x"
        f"{cfg.hidden_size} {str(cfg.dtype)[6:]}, vocab {cfg.vocab_size}, batch "
        f"{sizes['batch']} x ({sizes['text']} text + {sizes['img']} region slots, the last "
        f"{sizes.get('img_pad', 0)} masked) = S {s}, attention through "
        f"{ROUTE_NAMES[attn]}; dropout hidden {cfg.hidden_dropout_prob} / attention "
        f"{cfg.attention_probs_dropout_prob}; AdamW lr {trainer.learning_rate}, warmup "
        f"{trainer.warmup_steps}, clip {trainer.max_grad_norm}")
    bundles = []
    for batch in batches[:n_warm]:
        state, bundle = step(state, batch)
        bundles.append(bundle)
    sync()
    resident = None if REHEARSAL else torch.cuda.memory_allocated()
    if not REHEARSAL:
        torch.cuda.reset_peak_memory_stats()
    zero_counts()
    per_step, ms = None, []
    for batch in batches[n_warm:]:
        sync()
        t1 = time.perf_counter()
        state, bundle = step(state, batch)
        sync()
        ms.append((time.perf_counter() - t1) * 1e3)
        bundles.append(bundle)
        per_step = per_step or read_counts()
    totals = read_counts()
    peak = None if REHEARSAL else torch.cuda.max_memory_allocated()
    layers = cfg.num_hidden_layers
    check_counts(per_step, totals, {f"{attn}f": layers, f"{attn}b": layers, "K3f": 1,
                                    "K3b": 1, "K2f": 2 * layers + 2,
                                    "K2b": 2 * layers + 2}, n_timed)
    losses = torch.stack([torch.stack([b_[k] for k in ("loss", "mask_loss", "next_loss",
                                                         "token_loss")])
                          for b_ in bundles]).float().cpu()
    if not torch.isfinite(losses).all():
        fail(f"non-finite pretrain losses {losses.tolist()}")
    final = tree_leaves(state["params"])
    moved = sum(not torch.equal(a, b_) for a, b_ in zip(start, final))
    if moved < len(final) or not all(torch.isfinite(p).all() for p in final):
        fail(f"{moved} of {len(final)} parameters changed, or some are not finite")
    med = sorted(ms)[len(ms) // 2]
    flops, dense, attention, decoder = pretrain_flops(cfg, sizes)
    say(f"  loss (mask + next + token) per step: "
        f"{', '.join(f'{x:.4f}' for x in losses[:, 0].tolist())}; {moved} of {len(final)} "
        "parameter tensors changed")
    say(f"  {med:.2f} ms/step (median of {n_timed} steps, range {min(ms):.2f}-"
        f"{max(ms):.2f}), {sizes['batch'] / med * 1e3:.2f} examples/s; peak device "
        f"memory {'n/a' if peak is None else f'{peak / 2**30:.2f} GiB'} (resident "
        f"before the steps: {'n/a' if resident is None else f'{resident / 2**30:.2f} GiB'})")
    say(f"  analytic FLOPs per step {flops / 1e12:.3f} T (layers' Denses "
        f"{dense / 1e12:.3f}, attention {attention / 1e12:.3f}, tied MLM decoder "
        f"{decoder / 1e12:.3f}); MFU against 989 TFLOP/s bf16: "
        f"{flops / (med / 1e3) / H100_PEAK_BF16:.2%}")
    idle = None if REHEARSAL else profile_device(
        lambda: step(state, batches[n_warm]), "pretrain step", kinds=True)
    return {"ms_per_step": med, "counts": totals, "peak_bytes": peak, "idle": idle,
            "flops": flops, "trainer": trainer, "state": state,
            "batch": batches[n_warm]}


def phase_long_eval_and_remat(device, pt) -> None:
    """One eval_fn batch (K5f without the lse, no K5b) and one forward and
    backward with ``remat`` against one without, from the long-context
    phase's parameters, batch and one DropoutRng seed."""
    trainer, state, host_batch = pt["trainer"], pt["state"], pt["batch"]
    cfg, layers = trainer.cfg, trainer.cfg.num_hidden_layers
    say("long-context eval: one eval_fn batch")
    real_forward, lse_asked = attn_ops._flash_forward, []

    def spy(*args, **kw):
        out = real_forward(*args, **kw)
        lse_asked.append(out[1] is not None)
        return out

    attn_ops._flash_forward = spy
    try:
        zero_counts()
        bundle = trainer.eval_fn()(state["params"], host_batch)
        counts = read_counts()
    finally:
        attn_ops._flash_forward = real_forward
    say(f"  eval loss {float(bundle['loss']):.4f}; launches K5f {counts['K5f']}, K5b "
        f"{counts['K5b']}; flash forwards that wrote an lse: {sum(lse_asked)} of "
        f"{len(lse_asked)}")
    if not torch.isfinite(bundle["loss"]).all():
        fail("non-finite eval loss")
    if any(lse_asked) or len(lse_asked) != layers:
        fail(f"eval ran {len(lse_asked)} flash forwards, {sum(lse_asked)} with an lse")
    want = {"K5f": layers, "K3f": 1, "K2f": 2 * layers + 2}
    if not REHEARSAL and counts != {k: want.get(k, 0) for k in COUNTED}:
        fail(f"eval launches {counts}; expected {want}")

    say("long-context remat: one forward and backward with remat and one without, "
        "same parameters, batch and DropoutRng seeds")
    batch = trainer.to_device(host_batch)
    remat = PretrainTrainer(cfg.replace(remat=True), device=device)
    runs = {}
    for name, tr_ in (("plain", trainer), ("remat", remat)):
        rng = DropoutRng(masks=torch.Generator(device=device).manual_seed(SEED + 7),
                         seeds=torch.Generator().manual_seed(SEED + 7))
        sync()
        if not REHEARSAL:
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t1 = time.perf_counter()
        bundle, grads = tr_.loss_and_grads(state["params"], batch, rng)
        sync()
        seconds = time.perf_counter() - t1
        counts = read_counts()
        peak = None if REHEARSAL else torch.cuda.max_memory_allocated() - base
        runs[name] = (bundle, torch.cat([g.flatten() for g in tree_leaves(grads)]).cpu())
        del grads
        say(f"  {name}: loss {float(bundle['loss']):.6f}, {seconds * 1e3:.1f} ms (host "
            f"clock, one run), peak device memory above the resident state "
            f"{'n/a' if peak is None else f'{peak / 2**30:.2f} GiB'}; launches "
            f"{', '.join(f'{k} {v}' for k, v in counts.items() if v)}")
        want = ({"K5f": layers, "K5b": layers, "K3f": 1, "K3b": 1, "K2f": 2 * layers + 2,
                 "K2b": 2 * layers + 2} if name == "plain" else
                {"K5f": 2 * layers, "K5b": layers, "K3f": 1, "K3b": 1,
                 "K2f": 4 * layers + 2, "K2b": 2 * layers + 2})
        if not REHEARSAL and counts != {k: want.get(k, 0) for k in COUNTED}:
            fail(f"{name} launches {counts}; expected {want}")
    (b0, g0), (b1, g1) = runs["plain"], runs["remat"]
    same = {k: bool(torch.equal(b0[k], b1[k])) for k in b0 if k.endswith("loss")}
    say(f"  losses equal bit for bit: {same}")
    if not all(same.values()):
        fail("the remat step's losses differ from the plain step's")
    check_close(f"remat gradients vs plain ({g0.numel()} entries)", g1, g0,
                GRAD_TOL[cfg.dtype])


def phase_pretrain_agreement(device, sizes, attn: str = "K4",
                             what: str = "pretrain agreement", **cfg_kw) -> None:
    """Two fp32 pretrain steps with every dropout at 0 on a 2-item batch at
    BERT-base width and S ``text + agree_img`` (S 640: K4 runs; S 896 with
    ``use_flash_attention``: K5f runs, and the rate-0 backward is the plain
    recompute): the card (kernels) against the CPU (plain twins): the loss
    bundle, every gradient, and the AdamW update after two steps in units of
    lr (optax reads the schedule before the step, so the first step moves
    nothing)."""
    agree = {**sizes, "batch": 2, "img": sizes["agree_img"], "img_pad": 0}
    s = agree["text"] + agree["img"]
    say(f"{what}: two fp32 steps, dropouts 0, card vs CPU, 2 items at S {s}")
    rng = np.random.default_rng(SEED + 1)
    batches = [pretrain_batch(rng, agree, sizes["vocab"], 2054, 1601) for _ in range(2)]
    out = {}
    for dev in (device, "cpu"):
        cfg = pretrain_config(sizes, torch.float32, hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0, **cfg_kw)
        trainer = PretrainTrainer(cfg, learning_rate=5e-5, total_steps=100, device=dev)
        state = trainer.init_state()
        p0 = [t.clone() for t in tree_leaves(state["params"])]
        zero_counts()
        grads, bundles = [], []
        for b_ in batches:
            bundle, g = trainer.loss_and_grads(state["params"], trainer.to_device(b_), None)
            grads.append(torch.cat([x.flatten() for x in tree_leaves(g)]).cpu())
            bundles.append(bundle)
        step = trainer.step_fn()
        for b_ in batches:
            state, _ = step(state, b_)
        if dev == device:
            counts = read_counts()
        out[dev] = (bundles, grads, torch.cat([(p1 - p0_).flatten() for p1, p0_ in
                                               zip(tree_leaves(state["params"]), p0)]).cpu())
    layers = cfg.num_hidden_layers
    # Four forward and backward passes; the flash backward at rate 0 is the
    # plain recompute, as in the JAX package.
    want = {f"{attn}f": 4 * layers, f"{attn}b": 0 if attn == "K5" else 4 * layers,
            "K3f": 4, "K3b": 4, "K2f": 4 * (2 * layers + 2), "K2b": 4 * (2 * layers + 2)}
    say(f"  launches on {device} (4 forward and backward passes): "
        f"{', '.join(f'{k} {v}' for k, v in counts.items())}")
    if not REHEARSAL and counts != {k: want.get(k, 0) for k in COUNTED}:
        fail(f"the agreement run on {device} did not go through {attn} and K3 as "
             f"expected ({want}): {counts}")
    for i in range(2):
        for key, v in out["cpu"][0][i].items():
            if key.endswith("loss"):
                check_close(f"batch {i + 1} {key}", out[device][0][i][key].cpu(), v,
                            AGREE_TOL)
        say(f"  batch {i + 1} accuracies card / cpu: " + ", ".join(
            f"{k} {float(out[device][0][i][k]):.4f} / {float(v):.4f}"
            for k, v in out["cpu"][0][i].items() if k.endswith("accuracy")))
        check_close(f"batch {i + 1} gradients ({len(p0)} tensors)", out[device][1][i],
                    out["cpu"][1][i], AGREE_TOL)
    lr = 5e-5
    step_, want = out[device][2], out["cpu"][2]
    g1, g2 = out["cpu"][1]
    big = torch.minimum(g1.abs(), g2.abs()) > 10 * AGREE_TOL[0]
    diff = (step_ - want).abs()
    err = float(diff[big].max()) / lr
    say(f"  AdamW update after two steps ({int(big.sum())} of {g1.numel()} entries with "
        f"both |g| > {10 * AGREE_TOL[0]:g}): max|card - cpu| {err:.3g} lr (tolerance "
        f"1e-2 lr there, 3 lr elsewhere: max {float(diff.max()) / lr:.3g} lr); "
        f"{int((step_[big] != 0).sum())} of them moved")
    if not big.any():
        fail("no gradient entry large enough to check the AdamW update")
    if err > 1e-2 or float(diff.max()) > 3 * lr:
        fail(f"AdamW update disagrees between {device} and the CPU")
    if int((step_[big] != 0).sum()) < 0.95 * int(big.sum()):
        fail("the AdamW step on the card left parameters unmoved")


def phase_long_dropout_agreement(device, sizes) -> None:
    """One fp32 forward and backward at S ``text + agree_img`` with attention
    dropout 0.1 and hidden dropouts 0, card against CPU.  The kernels' hash
    seeds come from DropoutRng's CPU generator, seeded alike on both sides,
    so both draw the same masks: K5f and K5b on the card, their twins on the
    CPU."""
    agree = {**sizes, "batch": 2, "img": sizes["agree_img"], "img_pad": 0}
    s = agree["text"] + agree["img"]
    say(f"long-context dropout agreement: one fp32 step, attention dropout 0.1, hidden "
        f"dropouts 0, card vs CPU, 2 items at S {s}")
    host = pretrain_batch(np.random.default_rng(SEED + 2), agree, sizes["vocab"], 2054, 1601)
    out = {}
    for dev in (device, "cpu"):
        cfg = pretrain_config(sizes, torch.float32, hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.1, use_flash_attention=True)
        trainer = PretrainTrainer(cfg, device=dev)
        rng = DropoutRng(masks=torch.Generator(device=dev).manual_seed(SEED + 8),
                         seeds=torch.Generator().manual_seed(SEED + 8))
        zero_counts()
        bundle, grads = trainer.loss_and_grads(trainer.init_params(SEED), trainer.to_device(host),
                                               rng)
        if dev == device:
            counts = read_counts()
        out[dev] = (bundle, torch.cat([g.flatten() for g in tree_leaves(grads)]).cpu())
    layers = cfg.num_hidden_layers
    say(f"  launches on {device}: {', '.join(f'{k} {v}' for k, v in counts.items())}")
    want = {"K5f": layers, "K5b": layers, "K3f": 1, "K3b": 1, "K2f": 2 * layers + 2,
            "K2b": 2 * layers + 2}
    if not REHEARSAL and counts != {k: want.get(k, 0) for k in COUNTED}:
        fail(f"the dropout agreement run on {device} did not run K5f and K5b: {counts}")
    for key, v in out["cpu"][0].items():
        if key.endswith("loss"):
            check_close(key, out[device][0][key].cpu(), v, AGREE_TOL)
    check_close(f"gradients ({out['cpu'][1].numel()} entries)", out[device][1], out["cpu"][1],
                AGREE_TOL)


# Device times (torch.profiler) beside the event means: of the kernel and its
# SDPA yardstick (for the forwards at rate 0 without the lse), and of K4f's
# and K5f's call in their train step (rate 0.1, with the lse); null where no
# profiling session gave one, counted in ``device_times_unmeasured``.
DEVICE_KEYS = ("device_ms", "library_device_ms", "step_device_ms")


# -- phases 33-35: data parallelism (torch.distributed.run) ------------------------------

# Each dp phase runs in processes of its own, started through
# torch.distributed.run (``--standalone``: a rendezvous on localhost), so that
# no process group outlives its phase.  A rank runs this script with
# ``--dp-phase``.
DP_TIMEOUT_S = 420


def run_dp_child(phase: str, nproc: int, tmp: str, flag: str = "--dp-phase") -> dict:
    """Run ``phase`` (of ``flag``: ``--dp-phase``, ``--mp-phase`` or ``--pp-phase``) in
    ``nproc`` ranks; relay their output; rank 0's result."""
    out = os.path.join(tmp, f"{flag[2:4]}_{phase}.json")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), os.path.abspath(__file__), flag, phase,
           "--dp-result", out] + (["--cpu-rehearsal"] if REHEARSAL else [])
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=DP_TIMEOUT_S,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    for line in proc.stdout.splitlines():
        print(f"  | {line}", flush=True)
    if proc.returncode != 0:
        print(proc.stderr[-6000:], flush=True)
        fail(f"dp phase {phase!r} ({nproc} ranks) exited {proc.returncode}")
    say(f"  dp phase {phase!r}: {nproc} rank(s), {time.perf_counter() - t0:.1f} s with "
        "start-up")
    with open(out) as f:
        return json.load(f)


def dp_nav(sizes, device, dtype, dropouts: bool):
    """Phase 10's world on ``device`` and an NDH agent maker: BERT-base at
    ``dtype``, the agent's dropouts (or none)."""
    world, table, tok, _, train_instances, runtime = build_world(sizes, device, dtype)
    drop = {} if dropouts else {"hidden_dropout_prob": 0.0,
                                "attention_probs_dropout_prob": 0.0}
    cfg = BertConfig(vocab_size=len(tok), max_position_embeddings=sizes["seq"],
                     type_vocab_size=4, dtype=dtype, **drop, **sizes["bert"])

    def agent(mesh=None, zero1=False):
        return ViewpointAgent(cfg, runtime, feature_dim=sizes["feat"],
                              episode_len=sizes["episode_len"], rnn_dim=sizes["rnn"],
                              encoder_hidden_size=sizes["rnn"],
                              **({} if dropouts else {"dropout": 0.0}), device=device,
                              mesh=mesh, zero1=zero1)

    return agent, train_instances, runtime


def dp_update_check(name: str, want, got, lr: float) -> dict:
    """Two (loss, flat params) records of one step from the same start: the
    loss within 1e-5 relative, the parameters within 2 lr everywhere and
    1e-2 lr for at least 99% of them (an Adam step moves a parameter by
    ~lr; a gradient near eps may flip it)."""
    (l0, p0), (l1, p1) = want, got
    rel = abs(float(l1) - float(l0)) / max(abs(float(l0)), 1e-12)
    diff = (p1.float() - p0.float()).abs()
    close = float((diff <= 1e-2 * lr).float().mean())
    same = bool(torch.equal(p0, p1)) and float(l0) == float(l1)
    say(f"  {name}: loss {float(l1):.6f} vs {float(l0):.6f} (rel err {rel:.2e}), "
        f"params max|diff| {float(diff.max()) / lr:.3g} lr, {close:.4%} within 1e-2 lr; "
        f"bit for bit: {same}")
    if rel > 1e-5 or float(diff.max()) > 2 * lr or close < 0.99:
        fail(f"{name}: the data-parallel step disagrees with the one-process step")
    return {"loss_rel_err": rel, "max_diff_lr": float(diff.max()) / lr,
            "within_1e-2_lr": close, "bit_equal": same}


def dp_repeat(name: str, first, second) -> bool:
    """Whether two runs of the same single-device step from the same start
    give the same loss and parameters bit for bit (reported: the yardstick
    of the data-parallel steps' bit-for-bit equality)."""
    same = float(first[0]) == float(second[0]) and bool(torch.equal(first[1], second[1]))
    say(f"  {name} run twice: bit for bit: {same}"
        + ("" if same else f" (params max|diff| {float((first[1] - second[1]).abs().max()):.3g})"))
    return same


def flat_params(params) -> torch.Tensor:
    return torch.cat([t.detach().float().flatten().cpu() for t in tree_leaves(params)])


def dp_ndh_step(agent, batch, mesh=None):
    """(loss, flat params after one teacher-forced step) of ``agent`` on its
    rows of ``batch`` (a trimmed global batch)."""
    state = agent.init_state()
    new, loss = agent.train_step_fn()(state, parallel.shard_batch(mesh, batch))
    return loss.detach().cpu(), flat_params(new["params"])


def dp_pretrain_run(sizes, device, mesh, strategy: str, batches, **cfg_kw):
    """(loss of the last step, flat params) after ``len(batches)`` fp32
    pretraining steps with the dropouts at 0 unless ``cfg_kw`` sets them (the
    first AdamW step has lr 0); ``mesh`` None is the one-process trainer on
    the whole batches."""
    cfg = pretrain_config(sizes, torch.float32, **{"hidden_dropout_prob": 0.0,
                                                   "attention_probs_dropout_prob": 0.0,
                                                   **cfg_kw})
    trainer = PretrainTrainer(cfg, learning_rate=5e-5, total_steps=100, device=device,
                              mesh=mesh, zero1=strategy == "zero1", fsdp=strategy == "fsdp")
    state = trainer.init_state()
    step = trainer.step_fn()
    for batch in batches:
        state, bundle = step(state, parallel.shard_batch(mesh, batch))
    params = state["params"] if trainer.dp is None else trainer.dp.gather(
        state["params"], state["opt_state"])[0]
    out = (bundle["loss"].detach().cpu(), flat_params(params))
    del trainer, state, params
    release()
    return out


def release() -> None:
    if not REHEARSAL:
        torch.cuda.empty_cache()


def host_timed(fn) -> tuple:
    """(``fn()``, its ms on the host clock between two syncs)."""
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, (time.perf_counter() - t0) * 1e3


def dp_profile(fn, what: str) -> dict:
    """One warm call of ``fn`` under torch.profiler: device busy time, idle
    share, and the collectives' device time (NCCL or gloo kernels and the
    copies around them are named ``nccl*``; gloo's work is on the host)."""
    if REHEARSAL:
        return {"busy_ms": None, "wall_ms": None, "idle": None, "collective_ms": None}
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = device_kernels(prof)
    busy = sum(us for _, us in kernels)
    coll = [(name, us) for name, us in kernels if "nccl" in name.lower()]
    coll_us = sum(us for _, us in coll)
    # torch.cat's kernel: the flat buckets' packing (and the model's own cats).
    cat_us = sum(us for name, us in kernels if "CatArrayBatchedCopy" in name)
    out = {"busy_ms": busy / 1e3, "wall_ms": wall_us / 1e3,
           "idle": (1 - busy / wall_us) if kernels else None,
           "collective_ms": coll_us / 1e3, "collective_kernels": len(coll),
           "cat_ms": cat_us / 1e3, "device_kernels": len(kernels)}
    say(f"    profile of one {what}: {len(kernels)} device kernels, busy "
        f"{busy / 1e3:.2f} ms of {wall_us / 1e3:.2f} ms wall (idle share "
        f"{out['idle'] if out['idle'] is None else round(out['idle'] * 100, 1)}%), "
        f"collectives {len(coll)} kernels {coll_us / 1e3:.3f} ms, torch.cat kernels "
        f"{cat_us / 1e3:.3f} ms")
    return out


def dp_timed(name: str, make_state, step, batches, n_warm: int) -> dict:
    """``n_warm`` warm-up steps, then the rest timed one by one (host clock
    around a sync); launches and collectives counted over the timed run;
    peak memory; a profile of one more step."""
    state = make_state()
    for batch in batches[:n_warm]:
        state, _ = step(state, batch)
    sync()
    if not REHEARSAL:
        torch.cuda.reset_peak_memory_stats()
    zero_counts()
    parallel.reset_collective_counts()
    ms, losses = [], []
    for batch in batches[n_warm:]:
        sync()
        t1 = time.perf_counter()
        state, out = step(state, batch)
        sync()
        ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(float((out["loss"] if isinstance(out, dict) else out).float()))
    n = len(ms)
    launches = {k: v // n for k, v in read_counts().items()}
    coll = {k: v / n for k, v in parallel.collective_counts().items()}
    staged = parallel.p2p_host_staged.nbytes / n
    recv_ms = (parallel.recv_prev.seconds + parallel.recv_next.seconds) / n * 1e3
    peak = None if REHEARSAL else torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)):
        fail(f"{name}: non-finite losses {losses}")
    med = sorted(ms)[n // 2]
    say(f"  {name}: {med:.2f} ms/step (median of {n}, range {min(ms):.2f}-{max(ms):.2f}); "
        f"peak {'n/a' if peak is None else f'{peak / 2**30:.2f} GiB'}; launches a step "
        f"{', '.join(f'{k} {v}' for k, v in launches.items() if v)}; collectives a step "
        f"{', '.join(f'{k} {v:g}' for k, v in coll.items() if v)}")
    prof = dp_profile(lambda: step(state, batches[n_warm]), f"{name} step")
    del state
    release()
    return {"ms_per_step": med, "range": [min(ms), max(ms)], "peak_bytes": peak,
            "launches": launches, "collectives": coll, "staged_bytes": staged,
            "recv_ms": recv_ms, **prof}


def dp_world1(sz: dict) -> dict:
    """33. NCCL, a world of one: the dp / ZeRO-1 / FSDP steps in fp32 with the
    dropouts at 0 against the single-device step, then the bf16 timings."""
    device = parallel.init_process_group("cpu" if REHEARSAL else None)
    mesh = parallel.make_mesh(device=device)
    backend = dist.get_backend()
    say(f"dp world of one: backend {backend}, device {device}, rank {mesh.rank} of "
        f"{mesh.dp}")
    if backend != ("gloo" if REHEARSAL else "nccl"):
        fail(f"the world of one runs on {backend}, not NCCL")
    sizes, pre, long = sz["sizes"], sz["pre"], sz["long"]
    out = {"backend": backend}
    # The NDH step at full width, fp32.
    agent, instances, runtime = dp_nav(sizes, device, torch.float32, dropouts=False)
    batcher = NavEpisodeBatcher(instances, runtime, batch_size=sizes["batch"],
                                path_type="planner_path")
    plain = agent()
    batch = plain.trim_batch(next(batcher.train_batches(1, episode_len=sizes["episode_len"])))
    want = dp_ndh_step(plain, batch)
    out["ndh_plain_repeat"] = dp_repeat("NDH single-device step", want,
                                        dp_ndh_step(plain, batch))
    parallel.reset_collective_counts()
    zero_counts()
    got = dp_ndh_step(agent(mesh), batch, mesh)
    counts, coll = read_counts(), parallel.collective_counts()
    out["ndh_agree"] = dp_update_check(
        f"NDH dp step (fp32, batch {sizes['batch']}, S {batch['ids'].shape[1]})", want, got,
        plain.learning_rate)
    out["ndh_agree"]["collectives"] = coll
    say(f"    its launches {', '.join(f'{k} {v}' for k, v in counts.items() if v)}; "
        f"collectives {coll}")
    if coll["all_reduce_sum"] < 2 or coll["reduce_scatter"] or coll["all_gather"]:
        fail(f"the dp step's collectives {coll}: expected the counts' and the "
             "gradients' all-reduces, no reduce-scatter or all-gather at world 1")
    del plain, want, got
    release()
    # Pretraining at S 768 (K4) and S 1024 under FSDP (K5), fp32.
    rng = np.random.default_rng(SEED)
    batches = [pretrain_batch(rng, pre, pre["vocab"], 2054, 1601) for _ in range(2)]
    want = dp_pretrain_run(pre, device, None, "dp", batches)
    out["pretrain_plain_repeat"] = dp_repeat(
        "pretraining single-device steps", want,
        dp_pretrain_run(pre, device, None, "dp", batches))
    out["pretrain_agree"] = {}
    for strategy in ("dp", "zero1", "fsdp"):
        got = dp_pretrain_run(pre, device, mesh, strategy, batches)
        out["pretrain_agree"][strategy] = dp_update_check(
            f"pretrain {strategy} (fp32, batch {pre['batch']}, S "
            f"{pre['text'] + pre['img']}, 2 steps)", want, got, 5e-5)
    # Attention dropout 0.1 (K5b runs only at a rate above 0; at world 1 the
    # rank fold is 0, so both sides draw the same kernel seeds), hidden
    # dropouts 0.
    lng = {**long, "batch": max(long["batch"] // 2, 1)}
    rng = np.random.default_rng(SEED + 1)
    batches = [pretrain_batch(rng, lng, lng["vocab"], 2054, 1601) for _ in range(2)]
    flash = {"use_flash_attention": True, "attention_probs_dropout_prob": 0.1}
    want = dp_pretrain_run(lng, device, None, "dp", batches, **flash)
    zero_counts()
    got = dp_pretrain_run(lng, device, mesh, "fsdp", batches, **flash)
    out["long_fsdp_launches"] = {k: v // 2 for k, v in read_counts().items()}
    out["long_fsdp_agree"] = dp_update_check(
        f"pretrain fsdp with use_flash_attention, attention dropout 0.1 (fp32, batch "
        f"{lng['batch']}, S {lng['text'] + lng['img']}, 2 steps)", want, got, 5e-5)
    say(f"    its launches a step {out['long_fsdp_launches']}")
    layers = pretrain_config(lng, torch.float32).num_hidden_layers
    if not REHEARSAL and (out["long_fsdp_launches"]["K5f"] != layers
                          or out["long_fsdp_launches"]["K5b"] != layers):
        fail(f"the S 1024 FSDP step launched K5f / K5b {out['long_fsdp_launches']}, not "
             f"{layers} each")
    del want, got, batches
    release()
    # bf16 timings: NDH at batch 64 (phase 11's set-up), plain then dp.
    agent, instances, runtime = dp_nav(sizes, device, sizes["dtype"], dropouts=True)
    batcher = NavEpisodeBatcher(instances, runtime, batch_size=sizes["batch"],
                                path_type="planner_path")
    nb = list(batcher.train_batches(5, episode_len=sizes["episode_len"]))
    say(f"  bf16 timings (BERT-base {str(sizes['dtype'])[6:]}, the training dropouts)")
    out["ndh_time"] = {}
    # In turns, plain first and last (host-bound times drift within a call).
    for name, a in (("plain", agent()), ("dp", agent(mesh)), ("dp zero1", agent(mesh, True)),
                    ("plain again", agent())):
        out["ndh_time"][name] = dp_timed(f"NDH {name}", a.init_state, a.train_step_fn(),
                                         [a.trim_batch(b) for b in nb], 2)
    del agent, nb
    release()
    rng = np.random.default_rng(SEED + 2)
    pb = [pretrain_batch(rng, pre, pre["vocab"], 2054, 1601) for _ in range(3 + 2)]
    out["pretrain_time"] = {}
    for strategy in ("plain", "dp", "zero1", "fsdp", "plain again"):
        trainer = PretrainTrainer(pretrain_config(pre, pre["dtype"]), learning_rate=5e-5,
                                  total_steps=100, device=device,
                                  mesh=None if strategy.startswith("plain") else mesh,
                                  zero1=strategy == "zero1", fsdp=strategy == "fsdp")
        out["pretrain_time"][strategy] = dp_timed(
            f"pretrain {strategy} (S {pre['text'] + pre['img']})", trainer.init_state,
            trainer.step_fn(), pb, 2)
        del trainer
        release()
    return out


TWO_RANK_ARMS = {"ndh dp": ("all_reduce",), "ndh zero1": ("all_reduce", "all_gather"),
                 "pretrain zero1": ("all_reduce", "all_gather"),
                 "pretrain fsdp": ("all_reduce", "all_gather", "reduce_scatter")}


def dp_probe(mesh) -> dict:
    """Which collectives the group carries on this rank's tensors: each tried
    once on a few elements (every rank tries the same in the same order)."""
    x = torch.ones(2 * mesh.dp, device=mesh.device)
    tries = {"all_reduce": lambda: parallel.all_reduce_sum([x], mesh),
             "all_gather": lambda: parallel.all_gather([x], [0], mesh),
             "reduce_scatter": lambda: parallel.reduce_scatter([x], [0], mesh)}
    out = {}
    for name, fn in tries.items():
        try:
            fn()
            out[name] = None
        except (RuntimeError, ValueError, NotImplementedError) as err:
            out[name] = f"{type(err).__name__}: {str(err).splitlines()[0][:160]}"
    return out


def dp_two(sz: dict) -> dict:
    """35. Two ranks on the card(s): NCCL on two cards, else gloo with CUDA
    tensors on cuda:0 (NCCL refuses two ranks on one card): each arm's
    data-parallel step on the two halves of a batch against the one-process
    step on the whole batch (rank 0 computes it), fp32, dropouts 0."""
    two_cards = not REHEARSAL and torch.cuda.device_count() >= 2
    shared = not REHEARSAL and not two_cards
    device = parallel.init_process_group(
        "cpu" if REHEARSAL else ("cuda:0" if shared else None),
        backend=None if two_cards else "gloo")
    mesh = parallel.make_mesh(device=device)
    backend = dist.get_backend()
    say(f"dp two ranks: rank {mesh.rank}, backend {backend}, device {device}"
        + (" (both ranks on one card)" if shared else ""))
    probe = dp_probe(mesh)
    sizes, pre = sz["sizes"], sz["pre"]
    ran, not_run, out = [], {}, {"backend": backend, "shared_card": shared, "probe": probe}
    for arm, needs in TWO_RANK_ARMS.items():
        missing = [c for c in needs if probe[c] is not None]
        if missing:
            not_run[arm] = f"{backend} does not carry {', '.join(missing)} on " + \
                f"{device.type} tensors ({probe[missing[0]]})"
            continue
        if arm.startswith("ndh"):
            agent, instances, runtime = dp_nav(sizes, device, torch.float32, dropouts=False)
            batcher = NavEpisodeBatcher(instances, runtime, batch_size=sizes["batch"],
                                        path_type="planner_path")
            plain = agent()
            batch = plain.trim_batch(next(batcher.train_batches(
                1, episode_len=sizes["episode_len"])))
            want = host_timed(lambda: dp_ndh_step(plain, batch)) if mesh.rank == 0 else None
            del plain
            release()
            parallel.reset_collective_counts()
            got = host_timed(lambda: dp_ndh_step(agent(mesh, zero1=arm.endswith("zero1")),
                                                 batch, mesh))
            lr = 5e-5
        else:
            rng = np.random.default_rng(SEED + 3)
            batches = [pretrain_batch(rng, pre, pre["vocab"], 2054, 1601) for _ in range(2)]
            want = (host_timed(lambda: dp_pretrain_run(pre, device, None, "dp", batches))
                    if mesh.rank == 0 else None)
            parallel.reset_collective_counts()
            got = host_timed(lambda: dp_pretrain_run(pre, device, mesh, arm.split()[1],
                                                     batches))
            lr = 5e-5
        coll = parallel.collective_counts()
        if mesh.rank == 0:
            out[arm] = dp_update_check(f"two ranks, {arm}", want[0], got[0], lr)
            out[arm].update(collectives=coll, ms={"one_process": want[1], "two_ranks": got[1]})
            say(f"    collectives {coll}; host time (fresh state + the step(s)) one process "
                f"{want[1]:.1f} ms, two ranks {got[1]:.1f} ms")
        ran.append(arm)
        del want, got
        release()
    out["ran"], out["not_run"] = ran, not_run
    return out


def dp_child_main(args) -> int:
    """A rank of a dp phase (``--dp-phase``), of the mesh phase
    (``--mp-phase``) or of the pipeline phase (``--pp-phase``); rank 0
    writes the result."""
    global REHEARSAL
    REHEARSAL = args.cpu_rehearsal
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        if args.mp_phase:
            out = {"two": mp_two}[args.mp_phase](phase_sizes())
        elif args.pp_phase == "cli":
            out = pp_cli(os.path.dirname(args.dp_result))
        elif args.pp_phase:
            out = {"two": pp_two}[args.pp_phase](phase_sizes())
        else:
            out = {"world1": dp_world1, "two": dp_two}[args.dp_phase](phase_sizes())
        if dist.get_rank() == 0:
            with open(args.dp_result, "w") as f:
                json.dump(out, f)
    finally:
        parallel.destroy_process_group()
    return 0


def torchrun_worlds_of_one(runs: dict, tmp: str, prefix: str) -> dict:
    """Start ``python -m torch.distributed.run --standalone --nproc_per_node 1
    -m visitron_torch.run <argv> --output_dir <tmp>/<prefix><first word>``
    for every (name, argv) of ``runs`` at once (each a world of one; they
    share the card and the host), wait for all (DP_TIMEOUT_S) and return
    {name: (output dir, seconds with start-up)}.  A run that fails fails
    the phase with its output's tail; no process is left running."""
    repo = os.path.dirname(os.path.abspath(__file__))
    procs, done = {}, {}
    t0 = time.perf_counter()
    try:
        for name, argv in runs.items():
            d = os.path.join(tmp, prefix + name.split()[0])
            log = open(d + ".log", "w+")
            procs[name] = (d, log, subprocess.Popen(
                [sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc_per_node", "1", "-m", "visitron_torch.run", *argv,
                 "--output_dir", d], stdout=log, stderr=subprocess.STDOUT, cwd=repo))
        while len(done) < len(procs):
            for name, (_, _, proc) in procs.items():
                if name not in done and proc.poll() is not None:
                    done[name] = time.perf_counter() - t0
            if time.perf_counter() - t0 > DP_TIMEOUT_S:
                fail(f"torchrun {sorted(set(runs) - set(done))} did not end within "
                     f"{DP_TIMEOUT_S} s")
            time.sleep(0.2)
        for name, (_, log, proc) in procs.items():
            if proc.returncode != 0:
                log.seek(0)
                print(log.read()[-9000:], flush=True)
                fail(f"torchrun {name} exited {proc.returncode}")
        return {name: (d, done[name]) for name, (d, _, _) in procs.items()}
    finally:
        for _, log, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()


def phase_dp_cli(tmp: str) -> dict:
    """34. ``python -m torch.distributed.run --nproc_per_node 1 -m
    visitron_torch.run viewpoint --debug --zero1`` and ``pretrain --debug
    --fsdp`` on the card (NCCL, a world of one; BERT-base from the --debug
    workspace), both at once: their checkpoints in the single-device
    layout, finite losses."""
    if REHEARSAL:
        say("dp CLI: skipped in a rehearsal (the CLI under torchrun runs on the card)")
        return {}
    runs = {"viewpoint --zero1": ["viewpoint", "--config",
                                  "run_configs/viewpoint_train/ndh_oscar_setting.json",
                                  "--debug", "--zero1", "--num_iterations", "4",
                                  "--saving_steps", "2", "--logging_steps", "1",
                                  "--eval_iters", "4"],
            "pretrain --fsdp": ["pretrain", "--config",
                                "run_configs/pretrain/pretrain_ndh_r2r.json", "--debug",
                                "--fsdp", "--num_epochs", "1", "--logging_steps", "10"]}
    from visitron_torch.train.checkpoint import CheckpointManager

    out = {}
    for name, (d, seconds) in torchrun_worlds_of_one(runs, tmp, "dp_cli_").items():
        ckpt = CheckpointManager(d)
        steps = ckpt.steps()
        with open(os.path.join(d, "train.csv")) as f:
            losses = [float(r["loss"]) for r in csv.DictReader(f) if r.get("loss")]
        if not steps or not losses or not all(np.isfinite(losses)):
            fail(f"torchrun {name}: checkpoints {steps}, losses {losses[:5]}")
        opt = ckpt.restore_raw(steps[-1], "opt_state")
        params = ckpt.restore_raw(steps[-1])
        sd = params if name.startswith("pretrain") else params["encoder"]
        mu = opt[1]["mu"] if name.startswith("pretrain") else opt[1]["mu"]["encoder"]
        if any(mu[k].shape != v.shape for k, v in sd.items()):
            fail(f"torchrun {name}: the checkpoint's moments are not in the parameters' "
                 "layout")
        say(f"dp CLI: torchrun --nproc_per_node 1 {name}: {seconds:.1f} s with start-up "
            f"and val (contended: both runs at once on the card and host), checkpoints "
            f"{steps}, {len(losses)} logged losses (last {losses[-1]:.4f})")
        out[name] = {"seconds": seconds, "steps": steps}
    return out


def phase_dp(tmp: str) -> dict:
    """Phases 33-35."""
    release()
    world1 = run_dp_child("world1", 1, tmp)
    cli = phase_dp_cli(tmp)
    two = run_dp_child("two", 2, tmp)
    say(f"dp two ranks ({two['backend']}{', one card' if two['shared_card'] else ''}): "
        f"arms that ran: {', '.join(two['ran']) or 'none'}; arms that could not run: "
        + ("; ".join(f"{k} ({v})" for k, v in two["not_run"].items()) or "none"))
    if "ndh dp" not in two["ran"]:
        fail("the two-rank NDH dp step could not run")
    layers = BertConfig(**phase_sizes()["sizes"]["bert"]).num_hidden_layers
    want = {"ndh": {"K1f": layers, "K1b": layers, "K2f": 2 * layers + 1,
                    "K2b": 2 * layers + 1},
            "pretrain": {"K4f": layers, "K4b": layers, "K3f": 1, "K3b": 1,
                         "K2f": 2 * layers + 2, "K2b": 2 * layers + 2}}
    runs = {**{f"NDH {k}": ("ndh", v) for k, v in world1["ndh_time"].items()},
            **{f"pretrain {k}": ("pretrain", v) for k, v in world1["pretrain_time"].items()}}
    for name, (kind, run) in runs.items():
        if not REHEARSAL and run["launches"] != {k: want[kind].get(k, 0) for k in COUNTED}:
            fail(f"{name}: launches a step {run['launches']}, expected {want[kind]}")
    return {"world1": world1, "cli": cli, "two": two}


# -- phases 36-38: tensor, sequence and context parallelism ---------------------------------

MP_SEED = 2 ** 31 - 5  # the fold below wraps past int32, as the kernels read it


def mp_inputs(b, h, s, d, dtype, device, g):
    """(q, k, v, dout) (B, H, S, D) and a (B, S) key bias (a padded tail)."""
    q, k, v, dout = (torch.randn(b, h, s, d, generator=g, device=device).to(dtype)
                     for _ in range(4))
    lengths = torch.randint(s // 2, s + 1, (b,), generator=g, device=device)
    bias = torch.where(torch.arange(s, device=device)[None] < lengths[:, None],
                       0.0, -1e9).float().contiguous()
    return q, k, v, dout, bias


def pack(t):
    """(B, H, S, D) -> packed (B, S, H*D)."""
    return t.transpose(1, 2).flatten(2).contiguous()


def mp_call(kind: str, mesh):
    """``fn(q, k, v, bias, seed, rate)`` on (B, h, S, D) operands: ``kind``'s
    wrapper (K1 packs them) with the seed folded as on ``mesh``'s rank
    (``Mesh.kernel_seed``, as a rank's model calls it), returning (B, h, S,
    D)."""
    if kind == "K1":
        def fn(q, k, v, bias, seed, rate):
            out = fused_attention_packed(pack(q), pack(k), pack(v), bias, q.shape[1],
                                         mesh.kernel_seed(seed), rate)
            return out.unflatten(-1, (q.shape[1], q.shape[3])).transpose(1, 2)
        return fn
    wrap = fused_attention if kind == "K4" else flash_attention
    return lambda q, k, v, bias, seed, rate: wrap(q, k, v, bias, mesh.kernel_seed(seed),
                                                  rate)


def mp_twin(kind: str, q, k, v, bias, dout, seed, rate):
    """The plain twins' (out, dq, dk, dv) of ``kind`` with ``seed`` (the
    folded one), on (B, h, S, D) operands."""
    h = q.shape[1]
    if kind == "K1":
        out, lse = fused_attention_packed_reference(pack(q), pack(k), pack(v), bias, h, seed,
                                                    rate, need_lse=True)
        grads = fused_attention_packed_bwd_reference(pack(q), pack(k), pack(v), bias,
                                                     pack(dout), lse, h, seed, rate)
        unpack = lambda t: t.unflatten(-1, (h, q.shape[3])).transpose(1, 2)  # noqa: E731
        return (unpack(out), *map(unpack, grads))
    if kind == "K4":
        out, lse = fused_attention_reference(q, k, v, bias, seed, rate, need_lse=True)
        return (out, *fused_attention_bwd_reference(q, k, v, bias, dout, lse, seed, rate))
    out, lse = flash_attention_reference(q, k, v, bias, seed, rate, need_lse=True)
    return (out, *flash_attention_bwd_reference(q, k, v, bias, out, dout, lse, seed, rate))


def mp_keep_mask(fn, b, h, s, d, rate, device) -> torch.Tensor:
    """The keep mask ``fn`` (a forward at ``rate``) applies, read from its
    outputs: with q = k = 0 and no bias every probability is 1/S, and with v
    the identity on one block of D keys (zero elsewhere) the output at
    (query, j) is nonzero exactly where key block*D + j is kept.  (B, H, S,
    S) bool."""
    zero = torch.zeros(b, h, s, d, device=device)
    bias = torch.zeros(b, s, device=device)
    eye = torch.eye(d, device=device)
    blocks = []
    for c in range(s // d):
        v = torch.zeros(b, h, s, d, device=device)
        v[:, :, c * d:(c + 1) * d] = eye
        blocks.append(fn(zero, zero, v, bias, MP_SEED, rate) != 0)
    return torch.cat(blocks, dim=-1)


def phase_mp_kernels(device, mp) -> dict:
    """36. The tp and sp rank-local attention calls at full width, in one
    process: K1, K4 and K5 on a rank's 6 of 12 heads, the rank being (dp 1,
    tp 1) of a (2, 2) mesh, so that the seed takes both folds (seed +
    1000003 + 7919, past int32).  Each forward and
    backward (bf16, rate 0.1) against its twin with the folded seed, each
    keep mask (fp32) against the twins' bit for bit, and the device times of
    the 6-head calls beside the 12-head calls'."""
    mesh = parallel.Mesh(dp=2, rank=3, device=torch.device(device), axis="tp", size=2)
    folded = mesh.kernel_seed(MP_SEED)
    heads, d, rate = mp["heads"], mp["head_dim"], 0.1
    hl = heads // 2
    say(f"mesh kernels (phase 36): K1/K4/K5 on a tp/sp rank's {hl} of "
        f"{heads} heads, rank (dp 1, tp 1), seed {MP_SEED} folded to {folded} "
        f"({folded & 0xFFFFFFFF} as the kernels read it)")
    g = torch.Generator(device=device).manual_seed(SEED + 36)
    out = {}
    for kind in ("K1", "K4", "K5"):
        b, s = mp[kind]
        tag = f"{kind} B{b} S{s} {hl} heads"
        fn = mp_call(kind, mesh)
        q, k, v, dout, bias = mp_inputs(b, hl, s, d, torch.bfloat16, device, g)
        live = [t.detach().requires_grad_() for t in (q, k, v)]
        zero_counts()
        got = fn(*live, bias, MP_SEED, rate)
        got.backward(dout)
        launched = read_counts()
        want = mp_twin(kind, q, k, v, bias, dout, folded, rate)
        sync()
        err = check_close(f"out {tag} bf16 rate {rate}", got.detach(), want[0],
                          TOL[torch.bfloat16])
        for name, x, y in zip(("dq", "dk", "dv"), live, want[1:]):
            err = max(err, check_close(f"{name} {tag} bf16 rate {rate}", x.grad, y,
                                       GRAD_TOL[torch.bfloat16]))
        fwd, bwd = f"{kind}f", f"{kind}b"
        if not REHEARSAL and (launched[fwd] != 1 or launched[bwd] != 1):
            fail(f"{tag}: the wrapper launched {launched}, not one {fwd} and one {bwd}")
        mask = mp_keep_mask(fn, b, hl, s, d, rate, device)
        twin = attn_ops._head_keep_mask(folded, b, hl, s, rate, device, cols=s)
        same = bool(torch.equal(mask, twin))
        say(f"  keep mask {tag} (fp32, read from the outputs): equal to the twins' bit for "
            f"bit: {same} (kept share {float(mask.float().mean()):.4f})")
        if not same:
            fail(f"{tag}: the kernel's keep mask is not the twins' with the folded seed")
        res = {"max_abs_err": err, "mask_equal": same}
        if not REHEARSAL:
            # Device times: the 6-head shard beside the whole 12-head call.
            full = mp_inputs(b, heads, s, d, torch.bfloat16, device, g)
            whole = mp_call(kind, parallel.Mesh(dp=1, rank=0, device=torch.device(device)))
            times = {}
            for label, call, ops in (("6 heads", fn, (q, k, v, bias)),
                                     ("12 heads", whole, full[:3] + (full[4],))):
                fwd_ms = device_ms(lambda: call(*ops, MP_SEED, rate))
                leaves = [t.detach().requires_grad_() for t in ops[:3]]
                o = call(*leaves, ops[3], MP_SEED, rate)
                grad_out = dout if label == "6 heads" else full[3]
                bwd_ms = device_ms(lambda: torch.autograd.grad(o, leaves, grad_out,
                                                               retain_graph=True))
                # The attention kernels' own time (K1's packing copies and
                # the autograd bookkeeping around them left out).
                own = lambda ms: None if ms is None else sum(  # noqa: E731
                    t for name, t in ms.items() if "attention_" in name)
                times[label] = {"fwd_device_ms": own(fwd_ms), "bwd_device_ms": own(bwd_ms)}
                if fwd_ms is None or bwd_ms is None:
                    not_measured(f"{tag} {label}")
            say(f"  device time {tag} bf16 rate {rate} (torch.profiler, the attention "
                "kernels, mean of 5 calls): "
                + "; ".join(f"{k}: forward {v['fwd_device_ms']} ms, backward "
                            f"{v['bwd_device_ms']} ms" for k, v in times.items()))
            res["device_ms"] = times
        out[kind] = res
        del q, k, v, dout, live, got, want, mask, twin
        release()
    return out


# The two-rank arms of phase 37.  tp all-reduces and gathers its blocks into
# the single-device layout, sp exchanges heads and tokens, cp sends and
# receives the K/V blocks (through the host under gloo with CUDA tensors).
MP_ARMS = ("tp ndh", "tp pretrain", "sp pretrain", "cp pretrain")


def mp_probe(tp_mesh) -> list:
    """Each collective the arms need, tried once on a few elements over the
    row of ``tp_mesh`` (every rank tries the same in the same order); one
    that raises fails the phase, on every backend.  send/recv is the ring's
    shift: under gloo with CUDA tensors it goes through the host."""
    x = torch.ones(4, device=tp_mesh.device)
    tries = {"all_reduce": lambda: parallel.all_reduce_sum([x], tp_mesh, "axis"),
             "all_gather": lambda: parallel.all_gather([x], [0], tp_mesh, "axis"),
             "reduce_scatter": lambda: parallel.reduce_scatter([x], [0], tp_mesh, "axis"),
             "all_to_all": lambda: parallel.all_to_all(x.view(2, 2), tp_mesh),
             "send_recv": lambda: parallel.ring_shift([x], tp_mesh).finish()}
    for fn in tries.values():
        fn()
    sync()
    return list(tries)


def mp_ndh_step(agent, batch, mesh=None):
    """(loss, flat params after one teacher-forced step, in the single-device
    layout) of ``agent`` on its rows of ``batch``."""
    state = agent.init_state()
    new, loss = agent.train_step_fn()(state, parallel.shard_batch(mesh, batch))
    params = new["params"] if agent.dp is None else agent.dp.gather(
        new["params"], new["opt_state"])[0]
    return loss.detach().cpu(), flat_params(params)


def mp_two(sz: dict) -> dict:
    """37. Two ranks on the card(s): NCCL on two cards, else gloo with CUDA
    tensors on cuda:0 (the ring's shifts staged through the host).  After a
    probe of the collectives, every arm: the tp NDH teacher-forced step
    (batch 64), tp, sp and cp pretraining (S 768 batch 16; cp at S 1024
    batch 8), fp32 with the dropouts at 0, against rank 0's one-process step
    on the whole batch (phase 35's bounds), with the kernels' launches, the
    collectives and the bytes staged a step, and the host time of both runs
    (fresh state and the step or steps)."""
    two_cards = not REHEARSAL and torch.cuda.device_count() >= 2
    shared = not REHEARSAL and not two_cards
    device = parallel.init_process_group(
        "cpu" if REHEARSAL else ("cuda:0" if shared else None),
        backend=None if two_cards else "gloo")
    meshes = {"tp": parallel.make_mesh(tp=2, device=device),
              "sp": parallel.make_sp_mesh(None, 2, device=device),
              "cp": parallel.make_cp_mesh(None, 2, device=device)}
    rank, backend = dist.get_rank(), dist.get_backend()
    say(f"mesh two ranks: rank {rank}, backend {backend}, device {device}"
        + (" (both ranks on one card)" if shared else ""))
    probe = mp_probe(meshes["tp"])
    say(f"  collectives on {device.type} tensors: {', '.join(probe)} (each carried)")
    sizes, pre, long = sz["sizes"], sz["pre"], sz["long"]
    wants = {}
    out = {"backend": backend, "shared_card": shared, "probe": probe, "launches": {}}
    for arm in MP_ARMS:
        axis = arm.split()[0]
        mesh = meshes[axis]
        if arm == "tp ndh":
            agent, instances, runtime = dp_nav(sizes, device, torch.float32, dropouts=False)
            batcher = NavEpisodeBatcher(instances, runtime, batch_size=sizes["batch"],
                                        path_type="planner_path")
            plain = agent()
            batch = plain.trim_batch(next(batcher.train_batches(
                1, episode_len=sizes["episode_len"])))
            want = host_timed(lambda: mp_ndh_step(plain, batch)) if rank == 0 else None
            del plain
            release()
            parallel.reset_collective_counts()
            zero_counts()
            got = host_timed(lambda: mp_ndh_step(agent(mesh), batch, mesh))
            steps, what = 1, f"batch {sizes['batch']}, S {batch['ids'].shape[1]}"
        else:
            shape = {**long, "batch": max(long["batch"] // 2, 1)} if axis == "cp" else pre
            rng = np.random.default_rng(SEED + 37)
            batches = [pretrain_batch(rng, shape, shape["vocab"], 2054, 1601)
                       for _ in range(2)]
            # The tp and sp arms share their S 768 batches: one reference.
            key = "pretrain cp" if axis == "cp" else "pretrain"
            if rank == 0 and key not in wants:
                wants[key] = host_timed(lambda: dp_pretrain_run(shape, device, None, "dp",
                                                                batches))
            want = wants.get(key)
            parallel.reset_collective_counts()
            zero_counts()
            got = host_timed(lambda: dp_pretrain_run(shape, device, mesh, "dp", batches))
            steps = 2
            what = f"batch {shape['batch']}, S {shape['text'] + shape['img']}, 2 steps"
        launches = {k: v // steps for k, v in read_counts().items()}
        coll = {k: v / steps for k, v in parallel.collective_counts().items()}
        staged = parallel.p2p_host_staged.nbytes / steps
        if rank == 0:
            out[arm] = dp_update_check(f"two ranks, {arm} (fp32, {what})", want[0], got[0],
                                       5e-5)
            out[arm].update(collectives=coll, staged_bytes=staged,
                            ms={"one_process": want[1], "two_ranks": got[1]})
            say(f"    launches a step {', '.join(f'{k} {v}' for k, v in launches.items() if v)}"
                f"; collectives a step {', '.join(f'{k} {v:g}' for k, v in coll.items() if v)}"
                f"; staged through the host a step {staged / 2**20:.2f} MiB; host time "
                f"(fresh state + {steps} step(s)) one process {want[1]:.1f} ms, two ranks "
                f"{got[1]:.1f} ms")
        out["launches"][arm] = launches
        del want, got
        release()
    del wants
    return out


def phase_mp_cli(tmp: str) -> dict:
    """38. A world of one under torchrun: ``run pretrain --debug --mesh_sp 1``
    (batch 8) and ``run viewpoint --debug --mesh_tp 1`` (the flags accepted, a dp mesh
    of one rank over NCCL), both at once: checkpoints, finite losses,
    seconds with start-up."""
    if REHEARSAL:
        say("mesh CLI: skipped in a rehearsal (the CLI under torchrun runs on the card)")
        return {}
    runs = {"pretrain --mesh_sp 1": ["pretrain", "--config",
                                     "run_configs/pretrain/pretrain_ndh_r2r.json", "--debug",
                                     "--mesh_sp", "1", "--num_epochs", "1",
                                     "--per_gpu_train_batch_size", "8",
                                     "--logging_steps", "5"],
            "viewpoint --mesh_tp 1": ["viewpoint", "--config",
                                      "run_configs/viewpoint_train/ndh_oscar_setting.json",
                                      "--debug", "--mesh_tp", "1", "--num_iterations", "2",
                                      "--saving_steps", "2", "--logging_steps", "1",
                                      "--eval_iters", "2"]}
    from visitron_torch.train.checkpoint import CheckpointManager

    out = {}
    for name, (d, seconds) in torchrun_worlds_of_one(runs, tmp, "mp_cli_").items():
        steps = CheckpointManager(d).steps()
        with open(os.path.join(d, "train.csv")) as f:
            losses = [float(r["loss"]) for r in csv.DictReader(f) if r.get("loss")]
        if not steps or not losses or not all(np.isfinite(losses)):
            fail(f"torchrun {name}: checkpoints {steps}, losses {losses[:5]}")
        say(f"mesh CLI: torchrun --nproc_per_node 1 {name}: {seconds:.1f} s with start-up "
            f"(contended: both runs at once on the card and host), checkpoints {steps}, "
            f"{len(losses)} logged losses (last {losses[-1]:.4f})")
        out[name] = {"seconds": seconds, "steps": steps}
    return out


MP_WANT = {"tp ndh": "ndh", "tp pretrain": "pretrain", "sp pretrain": "pretrain",
           "cp pretrain": "ring"}


def phase_mp(tmp: str) -> dict:
    """Phases 37-38 (phase 36 runs in the main process)."""
    release()
    two = run_dp_child("two", 2, tmp, flag="--mp-phase")
    cli = phase_mp_cli(tmp)
    say(f"mesh two ranks ({two['backend']}{', one card' if two['shared_card'] else ''}): "
        f"every arm ran: {', '.join(MP_ARMS)}")
    layers = BertConfig(**phase_sizes()["sizes"]["bert"]).num_hidden_layers
    want = {"ndh": {"K1f": layers, "K1b": layers, "K2f": 2 * layers + 1,
                    "K2b": 2 * layers + 1},
            "pretrain": {"K4f": layers, "K4b": layers, "K3f": 1, "K3b": 1,
                         "K2f": 2 * layers + 2, "K2b": 2 * layers + 2},
            "ring": {"K3f": 1, "K3b": 1, "K2f": 2 * layers + 2, "K2b": 2 * layers + 2}}
    for arm in MP_ARMS:
        expect = {k: want[MP_WANT[arm]].get(k, 0) for k in COUNTED}
        if not REHEARSAL and two["launches"][arm] != expect:
            fail(f"two ranks, {arm}: launches a step {two['launches'][arm]}, expected "
                 f"{expect}")
    return {"two": two, "cli": cli}


# -- phase 39: pipeline parallelism -----------------------------------------------------------

def pp_pretrain_run(sizes, device, mesh, batches, microbatches: int):
    """(loss of the last step, flat params in the single-device layout)
    after ``len(batches)`` fp32 GPipe steps with the dropouts at 0, as
    ``dp_pretrain_run``'s (every rank takes part in the gather)."""
    cfg = pretrain_config(sizes, torch.float32, hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0)
    trainer = PipelinePretrainTrainer(cfg, mesh, num_microbatches=microbatches,
                                      learning_rate=5e-5, total_steps=100, device=device)
    state = trainer.init_state()
    step = trainer.step_fn()
    for batch in batches:
        state, bundle = step(state, parallel.shard_batch(mesh, batch))
    out = (bundle["loss"].detach().cpu(), flat_params(trainer.checkpoint_params(state)))
    del trainer, state
    release()
    return out


def pp_two(sz: dict) -> dict:
    """39. Two ranks on the card(s), a (dp 1, pp 2) pipeline: NCCL on two
    cards, else gloo with CUDA tensors on cuda:0 (the stage transfers
    staged through the host).  The fp32 steps against rank 0's one-process
    steps, then the bf16 steps with the dropouts on, timed, with each
    rank's launches a step."""
    two_cards = not REHEARSAL and torch.cuda.device_count() >= 2
    shared = not REHEARSAL and not two_cards
    device = parallel.init_process_group(
        "cpu" if REHEARSAL else ("cuda:0" if shared else None),
        backend=None if two_cards else "gloo")
    mesh = parallel.make_pp_mesh(None, 2, device=device)
    rank, backend = dist.get_rank(), dist.get_backend()
    pre, micro = sz["pre"], sz["pp"]["microbatches"]
    layers = pretrain_config(pre, torch.float32).num_hidden_layers
    say(f"pipeline two ranks: rank {rank} (stage {mesh.axis_index}), backend {backend}, "
        f"device {device}" + (" (both ranks on one card; stage transfers staged through "
                              "the host)" if shared else ""))
    rng = np.random.default_rng(SEED + 39)
    batches = [pretrain_batch(rng, pre, pre["vocab"], 2054, 1601) for _ in range(2)]
    want = dp_pretrain_run(pre, device, None, "dp", batches) if rank == 0 else None
    parallel.reset_collective_counts()
    got = pp_pretrain_run(pre, device, mesh, batches, micro)
    coll = parallel.collective_counts()
    what = (f"fp32, batch {pre['batch']}, S {pre['text'] + pre['img']}, {layers // 2} layers "
            f"a stage, M {micro}, 2 steps")
    out = {"backend": backend, "shared_card": shared, "microbatches": micro}
    if rank == 0:
        out["fp32"] = dp_update_check(f"two ranks, pp 2 ({what})", want, got, 5e-5)
        out["fp32"]["collectives"] = coll
        say(f"    collectives in the 2 steps {', '.join(f'{k} {v}' for k, v in coll.items() if v)}")
    del want, got
    release()
    # bf16, the dropouts on (hidden 0.1, attention 0.1: K4b with its masks).
    cfg = pretrain_config(pre, torch.bfloat16)
    trainer = PipelinePretrainTrainer(cfg, mesh, num_microbatches=micro, learning_rate=5e-5,
                                      total_steps=100, device=device)
    n_warm, n_timed = 2, sz["pp"]["steps"]
    timed = [pretrain_batch(rng, pre, pre["vocab"], 2054, 1601)
             for _ in range(n_warm + n_timed)]
    step = trainer.step_fn()
    run = dp_timed(f"pp 2 rank {rank} (bf16, dropouts on, M {micro})", trainer.init_state,
                   step, timed, n_warm)
    run["recv_share"] = run["recv_ms"] / run["ms_per_step"]
    say(f"    rank {rank}: host time in receives {run['recv_ms']:.2f} ms a step "
        f"({run['recv_share']:.1%} of the step; the schedule's bubble is "
        f"{1 / (micro + 1):.1%}), staged {run['staged_bytes'] / 2**20:.2f} MiB a step")
    ranks = parallel.all_gather_object(run, mesh)
    out["launches"] = {"first": ranks[0]["launches"], "last": ranks[-1]["launches"]}
    out["ranks"] = ranks
    return out


def phase_pp(tmp: str) -> dict:
    """Phase 39: the two-rank pipeline, each rank's launches a step against
    the schedule's."""
    release()
    two = run_dp_child("two", 2, tmp, flag="--pp-phase")
    micro = two["microbatches"]
    stage = pretrain_config(phase_sizes()["pre"], torch.float32).num_hidden_layers // 2
    body = {"K4f": stage * micro, "K4b": stage * micro, "K2f": 2 * stage * micro + 1,
            "K2b": 2 * stage * micro + 1}
    want = {"first": body, "last": {**body, "K3f": 1, "K3b": 1}}
    for rank, which in enumerate(("first", "last")):
        expect = {k: want[which].get(k, 0) for k in COUNTED}
        got = two["launches"][which]
        say(f"pipeline rank {rank} ({which} stage): launches a step "
            f"{', '.join(f'{k} {v}' for k, v in got.items() if v)}; expected "
            f"{', '.join(f'{k} {v}' for k, v in expect.items() if v)}")
        if not REHEARSAL and got != expect:
            fail(f"pipeline {which} stage: launches a step {got}, expected {expect}")
    two["cli"] = phase_pp_cli(tmp)
    return two


def pp_cli_argvs(out_dir: str) -> list:
    """Phase 40's two command lines: one epoch, then a second resumed."""
    argv = ["pretrain", "--config", "run_configs/pretrain/pretrain_ndh_r2r.json", "--debug",
            "--mesh_pp", "2", "--logging_steps", "5", "--output_dir", out_dir,
            *(REHEARSAL_SEQ if REHEARSAL else [])]
    return [argv + ["--num_epochs", "1"], argv + ["--num_epochs", "2", "--resume"]]


def pp_cli(tmp: str) -> dict:
    """40 (one card, or a rehearsal on the CPU): a rank of the pipeline CLI.
    The ranks join gloo on cuda:0 (both on one card; NCCL refuses that) and
    call ``run.main`` with each command line, which then runs in their
    group; each rank's launches in each run."""
    from visitron_torch import run

    device = parallel.init_process_group("cpu" if REHEARSAL else "cuda:0", backend="gloo")
    launches = []
    with cli_bert():
        for argv in pp_cli_argvs(os.path.join(tmp, "pp_cli")):
            zero_counts()
            run.main(argv, device=device)
            sync()
            launches.append(read_counts())
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, launches)
    return {"launches": {"first": ranks[0], "last": ranks[-1]}}


def phase_pp_cli(tmp: str) -> dict:
    """40. ``run pretrain --debug --mesh_pp 2`` and its ``--resume`` on two
    ranks: the torchrun CLI over NCCL with two cards, else ``--pp-phase
    cli`` (gloo on one card); the checkpoints' layouts, the resume, the
    validation and the losses checked."""
    from visitron_torch.train.checkpoint import CheckpointManager

    two_cards = not REHEARSAL and torch.cuda.device_count() >= 2
    out_dir = os.path.join(tmp, "pp_cli")
    t0 = time.perf_counter()
    if two_cards:
        arm, launches = "torchrun -m visitron_torch.run, NCCL, two cards", None
        for argv in pp_cli_argvs(out_dir):
            proc = subprocess.run([sys.executable, "-m", "torch.distributed.run",
                                   "--standalone", "--nproc_per_node", "2", "-m",
                                   "visitron_torch.run", *argv], capture_output=True,
                                  text=True, timeout=DP_TIMEOUT_S,
                                  cwd=os.path.dirname(os.path.abspath(__file__)))
            if proc.returncode != 0:
                print(proc.stdout[-3000:], proc.stderr[-6000:], flush=True)
                fail(f"torchrun pretrain --mesh_pp 2 exited {proc.returncode}")
    else:
        arm = "run.main in two torchrun ranks, gloo" + ("" if REHEARSAL else " on one card")
        launches = run_dp_child("cli", 2, tmp, flag="--pp-phase")["launches"]
    seconds = time.perf_counter() - t0
    ckpt = CheckpointManager(out_dir)
    steps = ckpt.steps()
    if len(steps) != 2 or steps[1] != 2 * steps[0] or steps[0] <= 0:
        fail(f"pipeline CLI: checkpoints {steps}, expected [n, 2n]")
    with open(os.path.join(out_dir, "train.csv")) as f:
        rows = list(csv.DictReader(f))
    losses = [float(r["loss"]) for r in rows if r.get("loss")]
    val = [float(r["ndh_val_seen/loss"]) for r in rows if r.get("ndh_val_seen/loss")]
    if not losses or not val or not all(np.isfinite(losses + val)):
        fail(f"pipeline CLI: losses {losses[:5]}, validation losses {val}")
    with open(os.path.join(out_dir, "train.log")) as f:
        if f"resumed from checkpoint-{steps[0]}" not in f.read():
            fail("pipeline CLI: the second run did not resume from the first's checkpoint")
    # The parameters in the single-device layout: a one-process trainer of
    # the same BERT loads them.
    params = ckpt.restore_raw(steps[-1])
    shape = {k: tuple(v.shape) for k, v in params.items()}
    layers = len({k.split(".")[2] for k in shape if k.startswith("bert.encoder.layer_")})
    hidden = shape["bert.word_embeddings.weight"][1]
    cfg = BertConfig(
        vocab_size=shape["mlm_bias"][0], num_hidden_layers=layers, hidden_size=hidden,
        num_attention_heads=hidden // 64,
        intermediate_size=shape["bert.encoder.layer_0.intermediate.weight"][0],
        max_position_embeddings=shape["bert.embeddings.position_embeddings.weight"][0],
        type_vocab_size=shape["bert.embeddings.token_type_embeddings.weight"][0],
        img_feature_dim=shape["bert.img_embedding.weight"][1],
        detector_classes=shape["token_head.weight"][0])
    one = PretrainTrainer(cfg, device="cpu")
    loaded = ckpt.restore(steps[-1], {"params": one.init_params()})["params"]
    if any(not torch.equal(loaded[k], v) for k, v in params.items()):
        fail("pipeline CLI: a one-process trainer does not load the checkpoint as saved")
    mu = ckpt.restore_raw(steps[-1], "opt_state")[1]["mu"]
    qkv = tuple(mu["stages"]["attention.qkv.weight"].shape) if "stages" in mu else None
    if set(mu) != {"rest", "stages"} or qkv != (layers, 3 * hidden, hidden):
        fail(f"pipeline CLI: the optimizer state is not in the pipeline's layout "
             f"({sorted(mu)}, stacked qkv {qkv})")
    del one, loaded, params
    if launches is not None:
        # Both stages launch K2 and the attention kernels the model's
        # dispatch picks at the run's joint length (S 704 at the --debug
        # world's: the plain attention, as phase 22's one-process run); the
        # last stage alone K3.
        first, last = (launches[which][0] for which in ("first", "last"))
        ran = {which: {k for k, v in got.items() if v}
               for which, got in (("first", first), ("last", last))}
        if not REHEARSAL and (not {"K2f", "K2b"} <= ran["first"]
                              or ran["last"] != ran["first"] | {"K3f", "K3b"}
                              or ran["first"] & {"K3f", "K3b"}):
            fail(f"pipeline CLI: launches in the first run, first stage {first}, last "
                 f"stage {last}")
        say(f"pipeline CLI: launches in the first run, first stage "
            f"{', '.join(f'{k} {v}' for k, v in first.items() if v)}; last stage "
            f"{', '.join(f'{k} {v}' for k, v in last.items() if v)}")
        launches = {"first": first, "last": last}
    say(f"pipeline CLI ({arm}): run pretrain --debug --mesh_pp 2, then --resume: "
        f"{seconds:.1f} s with start-up and val, checkpoints {steps}, {len(losses)} logged "
        f"losses (last {losses[-1]:.4f}), validation losses {[round(v, 4) for v in val]}; "
        f"params in the single-device layout ({layers} layers), moments stacked {qkv}")
    return {"arm": arm, "seconds": seconds, "steps": steps, "launches": launches}


def kernels_line(times, sl, tr, pt, lc, st, rl, cli, opt, scene, regions, dp, mp,
                 pp, t40, bf16) -> dict:
    """One entry per kernel: K1f and K2f at the serving bucket with the
    serving run's launches, K1b and K2b at the train bucket with the train
    run's, K3f/K3b and K4f/K4b at the pretraining shapes with the pretrain
    run's, K5f/K5b at the long-context shape with the long-context run's;
    the attention kernels also with their device times (DEVICE_KEYS).  The
    four NDH kernels also carry ``path_launches``: their launches in the
    timed runs of the teacher-forced, sampled and RL train steps.  Every
    kernel carries ``cli_launches``: its launches per iteration of phase
    22's viewpoint and pretrain runs, of phase 23's turn_based run, per
    batch of its argmax rollout, per iteration of phase 24's classifier run,
    of phase 25's viewpoint run from the HF file, of phase 28's speaker
    and ``--aug_data`` fine-tune runs, of phase 29's ``--no_use_fused_layernorm``
    run and per run of phase 32's extract tasks;
    ``option_and_feature_launches``: its launches in phase 29's history-K/V
    forward, a phase 30 scene forward and a phase 31 detector dispatch; and
    ``dp_launches``: its launches a step of phase 33's data-parallel runs
    (NCCL, a world of one): the NDH dp and dp + ZeRO-1 steps, the S 768
    pretraining step under dp, ZeRO-1 and FSDP, the S 1024 FSDP step; and
    ``mp_launches``: its launches a step in phase 37's two-rank arms (rank
    0's; null for an arm the group could not carry); ``pp_launches``: its
    launches a step on each rank of phase 39's pipeline (bf16, dropouts
    on); ``pp_cli_launches``: its launches on each rank in phase 40's first
    run (one epoch with validation; null where the CLI ran under NCCL on
    two cards, in processes the script cannot count in); ``t40_launches``:
    its launches in phase 41 a teacher-forced step and a serving batch at
    40-step episodes and in the remat forward and backward;
    ``bf16_moments_launches``: its launches a step of phase 42's
    bf16-moment step."""
    code = {fn.__name__: k for k, fn in COUNTED.items()}
    ndh = {"fused_attention_packed": "K1f", "fused_add_layernorm": "K2f",
           "fused_attention_packed_bwd": "K1b", "fused_add_layernorm_bwd": "K2b"}
    runs = sl["runs"][False]
    rows = (sl["ln_rows"], tr["ln_rows"])
    entries = (("fused_attention_packed", ATTN_SOURCE, times["k1"][sl["bucket"]],
                runs["k1"]),
               ("fused_add_layernorm", LN_SOURCE, times["k2"][rows[0]], runs["k2"]),
               ("fused_attention_packed_bwd", (ATTN_SOURCE[0], ATTN_BWD_REPLACES),
                times["k1b"][tr["bucket"]], tr["k1b"]),
               ("fused_add_layernorm_bwd", (LN_SOURCE[0], LN_BWD_REPLACES),
                times["k2b"][rows[1]], tr["k2b"]),
               ("fused_masked_softmax_ce", (CE_SOURCE, CE_REPLACES[0]), times["k3"],
                pt["counts"]["K3f"]),
               ("fused_masked_softmax_ce_bwd", (CE_SOURCE, CE_REPLACES[1]), times["k3b"],
                pt["counts"]["K3b"]),
               ("fused_attention", (ATTN_SOURCE[0], ATTN4_REPLACES[0]), times["k4"],
                pt["counts"]["K4f"]),
               ("fused_attention_bwd", (ATTN_SOURCE[0], ATTN4_REPLACES[1]), times["k4b"],
                pt["counts"]["K4b"]),
               ("flash_attention", (ATTN_SOURCE[0], FLASH_REPLACES[0]), times["k5"],
                lc["counts"]["K5f"]),
               ("flash_attention_bwd", (ATTN_SOURCE[0], FLASH_REPLACES[1]), times["k5b"],
                lc["counts"]["K5b"]))
    for name, _, t, _ in entries[:4]:
        # The main path's kernels: their device times are what the Hopper
        # redesigns are held to, so a run without them fails.
        if t.get("device_ms") is None or t.get("library_device_ms") is None:
            fail(f"{ndh[name]} ({name}): no device time at the path's shape")
    return {"device_times_unmeasured": len(UNMEASURED), "kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches, "max_abs_err": t["max_abs_err"], "ms": t["ms"],
         "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
         "library_ms": t["library_ms"],
         **{k: t[k] for k in DEVICE_KEYS if k in t},
         **({"path_launches": {path: run["counts"][ndh[name]] for path, run in
                               (("train", tr), ("sampled_train", st), ("rl_train", rl))}}
            if name in ndh else {}),
         "cli_launches": {"viewpoint": cli["vp_counts"][code[name]],
                          "pretrain": cli["pt_counts"][code[name]],
                          "turn_based": cli["turn_based"]["counts"][code[name]],
                          "turn_based_rollout": cli["turn_based"]["rollout"]["counts"][
                              code[name]],
                          "classifier": cli["classifier"]["counts"][code[name]],
                          "viewpoint_from_hf": cli["oscar"]["counts"][code[name]],
                          "speaker": cli["speaker"]["counts"][code[name]],
                          "viewpoint_aug_data": cli["speaker"]["vp_counts"][code[name]],
                          "viewpoint_no_fused_layernorm":
                              cli["no_fused_ln"]["counts"][code[name]],
                          "extract_scene": cli["extract"]["extract_scene"]["counts"][code[name]],
                          "extract_regions":
                              cli["extract"]["extract_regions"]["counts"][code[name]]},
         "option_and_feature_launches": {
             "history_kv_forward": opt["counts"][code[name]],
             "scene_forward": scene["bfloat16"]["counts"][code[name]],
             "region_dispatch": regions["float32"]["counts"][code[name]]},
         "dp_launches": {
             "ndh_dp_step": dp["world1"]["ndh_time"]["dp"]["launches"][code[name]],
             "ndh_zero1_step": dp["world1"]["ndh_time"]["dp zero1"]["launches"][code[name]],
             **{f"pretrain_{k}": dp["world1"]["pretrain_time"][k]["launches"][code[name]]
                for k in ("dp", "zero1", "fsdp")},
             "long_fsdp_s1024": dp["world1"]["long_fsdp_launches"][code[name]]},
         "mp_launches": {arm.replace(" ", "_"): mp["two"]["launches"][arm][code[name]]
                         for arm in MP_ARMS},
         "pp_launches": {stage: pp["launches"][stage][code[name]]
                         for stage in ("first", "last")},
         "pp_cli_launches": ({stage: pp["cli"]["launches"][stage][code[name]]
                              for stage in ("first", "last")}
                             if pp["cli"]["launches"] else None),
         "t40_launches": {"train_step": t40["train"]["launches"][code[name]],
                          "serving_batch": t40["serving"]["launches"][code[name]],
                          "remat_forward_backward":
                              t40["remat"]["remat_launches"][code[name]]},
         "bf16_moments_launches": bf16["launches"][code[name]]}
        for name, (src, replaces), t, launches in entries]}


def phase_sizes() -> dict:
    """Every phase's shapes: a rehearsal's tiny ones, or the card's."""
    if REHEARSAL:
        attn = {"batch": 2, "heads": 2, "head_dim": 64, "seqs": (128,)}
        ln = {"hidden": 128, "rows": (2 * 128,)}
        sizes = {"scans": 1, "viewpoints": 12, "feat": 32, "instances": 6, "seq": 128,
                 "batch": 4, "episode_len": 3, "long_episode_len": 6, "rnn": 24,
                 "dtype": torch.float32,
                 "draws": 20_000, "bert": {"num_hidden_layers": 2, "hidden_size": 128,
                          "num_attention_heads": 2, "intermediate_size": 256}}
        ce = {"rows": 64, "vocab": 4099}
        attn4 = {"batch": 2, "heads": 2, "head_dim": 64, "seq": 256}
        pre = {"batch": 2, "text": 128, "img": 128, "agree_img": 128, "vocab": 4099,
               "positions": 128, "steps": 2, "dtype": torch.float32,
               "bert": {**sizes["bert"], "fused_packed_max_seq": 128}}
        # S 896 = 128 text + 768 region slots: past the fused gate, as on the card.
        long = {**pre, "img": 768, "img_pad": 8, "agree_img": 768}
        flash = {"batch": 2, "heads": 2, "head_dim": 64, "seq": 256, "pad": 8,
                 "long_batch": 1, "long_seq": 512, "cross": (128, 256), "fused_seq": 256}
        spk = {"batch": 4, "episode_len": 6, "max_words": 12, "rnn": 24, "wemb": 16,
               "feat": sizes["feat"], "vocab": 30522, "agree": 2}
        opt = {"batch": 2, "fresh": 16, "history": 24, "agree": 2, "dtype": torch.float32,
               "bert": sizes["bert"]}
        scene = {"depth": 50, "w": 64, "h": 48, "vfov": 60, "face": 64, "panos": 2,
                 "iters": 1, "agree_views": 2}
        regions = {"depth": 50, "classes": 12, "attrs": 7, "rois": 8, "pre_nms": 256,
                   "side": 256, "vfov": 80, "per_dispatch": 6, "face": 64, "dispatches": 1}
        extract = {"face": 32}
        mp = {"heads": 4, "head_dim": 64, "K1": (2, 128), "K4": (2, 256), "K5": (2, 256)}
        pp = {"microbatches": 2, "steps": 2}
        tiny_world = {"num_scans": 2, "viewpoints_per_scan": 12, "scene_feat_dim": 32}
        tiny_agent = {"rnn_dim": 24, "encoder_hidden_size": 24}
        rs = {"world": tiny_world, "instances": 8, "seq": 128, "batch": 4, "timed": 2,
              "bert": sizes["bert"], "agent": tiny_agent, "dtype": torch.float32}
        sci = {"world": tiny_world, "episodes": 12, "seq": 128, "batch": 4, "iters": 20,
               "bert": sizes["bert"], "agent": tiny_agent, "dtype": torch.float32}
        ab = {"speaker_iters": 200, "iters": 20, "n_aug": 16,
              "sizes": {"world": tiny_world, "bert": {"num_hidden_layers": 1},
                        "train_episodes": 12, "val_episodes": 8, "batch": 4}}
    else:
        attn = {"batch": 64, "heads": 12, "head_dim": 64, "seqs": (256, 512)}
        # R 12288: the S 768 pretraining step's; 16384 and 32768: NDH at S 256
        # and 512 (16384 also the S 1024 step's).
        ln = {"hidden": 768, "rows": (16 * 768, 64 * 256, 64 * 512)}
        # bench.py's world; phase 41 at its BENCH_EPISODE_LEN=40 workload.
        sizes = {"scans": 4, "viewpoints": 60, "feat": 2048, "instances": 128,
                 "seq": 512, "batch": 64, "episode_len": 10, "long_episode_len": 40,
                 "rnn": 512, "dtype": torch.bfloat16, "draws": 65536, "bert": {}}
        # tools/bench_pretrain.py: batch 16 x (512 text + 256 regions) = S 768.
        ce = {"rows": 16 * 768, "vocab": 30525}
        attn4 = {"batch": 16, "heads": 12, "head_dim": 64, "seq": 768}
        pre = {"batch": 16, "text": 512, "img": 256, "agree_img": 128, "vocab": 30525,
               "positions": 768, "steps": 5, "dtype": torch.bfloat16, "bert": {}}
        # The long-context cell: 512 text + 512 region slots (36 views x 14
        # regions = 504, bucketed by 64) = S 1024; agreement at S 896.
        long = {**pre, "img": 512, "img_pad": 8, "agree_img": 384}
        flash = {"batch": 16, "heads": 12, "head_dim": 64, "seq": 1024, "pad": 8,
                 "long_batch": 2, "long_seq": 4096, "cross": (512, 1024), "fused_seq": 768}
        # run_configs/pipeline/speaker.json: batch 32, trusted path (40-step
        # trajectories), 80 words; rnn 512, wemb 256; BERT-base's vocabulary.
        spk = {"batch": 32, "episode_len": 40, "max_words": 80, "rnn": 512, "wemb": 256,
               "feat": sizes["feat"], "vocab": 30522, "agree": 4}
        # BERT-base, batch 16, 128 fresh tokens over 384 history tokens a layer.
        opt = {"batch": 16, "fresh": 128, "history": 384, "agree": 2,
               "dtype": torch.bfloat16, "bert": {}}
        # The JAX package's production geometry (visitron_tpu/run.py:478-562,
        # FasterRCNN's defaults), over 1024 px skybox faces.
        scene = {"depth": 152, "w": 640, "h": 480, "vfov": 60, "face": 1024, "panos": 2,
                 "iters": 5, "agree_views": 2}
        regions = {"depth": 101, "classes": 1601, "attrs": 401, "rois": 300,
                   "pre_nms": 6000, "side": 600, "vfov": 80, "per_dispatch": 6,
                   "face": 1024, "dispatches": 6}
        extract = {"face": 1024, "depth": 152}
        # Phase 36: the tp/sp shards (6 of 12 heads) at the paths' shapes.
        mp = {"heads": 12, "head_dim": 64, "K1": (64, 256), "K4": (16, 768),
              "K5": (16, 1024)}
        # Phase 39: pp 2 of BERT-base's 12 layers, 8 microbatches of 2 rows.
        pp = {"microbatches": 8, "steps": 4}
        # Phases 43-44: tools/realscale_smoke.py's and tools/synthetic_e2e.py's
        # configurations (their worlds: visitron_torch.testing.realscale.WORLD,
        # science.WORLD), the science run at the tool's 1000 iterations: at
        # 400, the decoder's 0.5 dropouts leave the loss at 0.68-0.73x its
        # start on the card and, at a reduced width on the CPU, in the JAX
        # package too (PERF.md).
        rs = {"world": {}, "instances": 128, "seq": 512, "batch": 64, "timed": 3,
              "bert": {}, "agent": {}, "dtype": torch.bfloat16}
        sci = {"world": {}, "episodes": 200, "seq": 512, "batch": 32, "iters": 1000,
               "bert": {}, "agent": {}, "dtype": torch.bfloat16}
        # Phase 45: tools/aug_ab.py's world and widths (VALIDATION.md rounds
        # 3-4), the budget cut to fit the script's time (PERF.md).
        ab = {"speaker_iters": 600, "iters": 250, "n_aug": 300, "sizes": {}}
    return {"attn": attn, "ln": ln, "sizes": sizes, "ce": ce, "attn4": attn4, "pre": pre,
            "long": long, "flash": flash, "spk": spk, "opt": opt, "scene": scene,
            "regions": regions, "extract": extract, "mp": mp, "pp": pp, "realscale": rs,
            "science": sci, "aug_ab": ab}


def share_bytecode() -> tempfile.TemporaryDirectory:
    """Have the processes the script starts (torchrun and its ranks) keep
    and reuse the bytecode of the modules they import, in a directory
    removed at exit: on the card's machine Python runs with
    PYTHONDONTWRITEBYTECODE and compiles every module it imports from
    source, some 1,700 (torch's) and ~8 s in each process."""
    pyc = tempfile.TemporaryDirectory(prefix="chip_smoke_pyc_")
    os.environ["PYTHONPYCACHEPREFIX"] = pyc.name
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    return pyc


def main(argv=None) -> int:
    global REHEARSAL
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run every phase at a tiny size with the plain twins on "
                         "the CPU; prints no result")
    ap.add_argument("--dp-phase", choices=("world1", "two"),
                    help="run one rank of a data-parallel phase (started by the "
                         "script itself through torch.distributed.run)")
    ap.add_argument("--mp-phase", choices=("two",),
                    help="run one rank of the tensor / sequence / context-parallel phase "
                         "(started by the script itself through torch.distributed.run)")
    ap.add_argument("--pp-phase", choices=("two", "cli"),
                    help="run one rank of the pipeline-parallel phase (started by the "
                         "script itself through torch.distributed.run)")
    ap.add_argument("--dp-result", help="where rank 0 of a --dp-phase, --mp-phase or "
                    "--pp-phase writes its result")
    args = ap.parse_args(argv)
    if args.dp_phase or args.mp_phase or args.pp_phase:
        return dp_child_main(args)
    REHEARSAL = args.cpu_rehearsal
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pyc = share_bytecode()  # noqa: F841 (removed when it is collected at exit)
    t_start = LAP[0] = time.perf_counter()
    device = "cpu" if REHEARSAL else "cuda"
    sz = phase_sizes()
    attn, ln, sizes, ce, attn4, pre, long, flash, spk, opt, scene, regions, extract = (
        sz[k] for k in ("attn", "ln", "sizes", "ce", "attn4", "pre", "long", "flash", "spk",
                        "opt", "scene", "regions", "extract"))
    dev_info = phase_device()
    smi = dev_info.pop("nvidia_smi", None)
    phase_build()
    lap("phases 1-2 (device, build)")
    # First, before any torch.profiler session: after the profiled phases
    # (CUPTI kept up, TEARDOWN_CUPTI=0) its launch-bound loop ran at 0.8x
    # the nav actions/s of a process of its own (PERF.md).
    sci = phase_science(device, sz["science"])
    lap("phase 44 (the science run)")
    ab = phase_aug_ab(device, sz["aug_ab"])
    lap("phase 45 (the back-translation A/B)")
    times = {"k1": phase_k1(device, attn), "k2": phase_k2(device, ln),
             "k1b": phase_k1b(device, attn), "k2b": phase_k2b(device, ln),
             **phase_k3(device, ce), **phase_k4(device, attn4), **phase_k5(device, flash)}
    mp_kernels = phase_mp_kernels(device, sz["mp"])
    lap("phases 3-9, 36 (the kernels against their twins)")
    sl = phase_serving(device, sizes)
    sl["ln_rows"] = sizes["batch"] * sl["bucket"]
    phase_agreement(device, sizes, sl)
    tr = phase_train(device, sizes, sl)
    tr["ln_rows"] = sizes["batch"] * tr["bucket"]
    phase_train_agreement(device, sizes, sl)
    lap("phases 10-11 (serving, train, agreement)")
    pt = phase_pretrain(device, pre)
    del pt["trainer"], pt["state"]  # the long-context phase's peak memory is its own
    phase_pretrain_agreement(device, pre)
    lc = phase_pretrain(device, long, "K5", "long-context pretrain: the pretraining "
                        f"step at S {long['text'] + long['img']}", use_flash_attention=True)
    phase_long_eval_and_remat(device, lc)
    del lc["trainer"], lc["state"]
    phase_pretrain_agreement(device, long, "K5", "long-context agreement",
                             use_flash_attention=True)
    phase_long_dropout_agreement(device, long)
    lap("phases 12-15 (pretraining)")
    st = phase_student(device, sizes, sl, rl=False)
    del st["state"]
    rl = phase_student(device, sizes, sl, rl=True)
    phase_no_sync(sl, rl)
    del rl["state"]
    phase_student_agreement(device, sizes, sl)
    phase_sampling(device, sizes["draws"])
    phase_evaluate(sl)
    lap("phases 16-21 (sampled, RL, sampling, evaluate)")
    t40 = phase_t40(device, sizes, sl)
    bf16 = phase_bf16_moments(device, sizes, sl)
    lap("phases 41-42 (T 40, bf16 moments)")
    rs = phase_realscale(device, sz["realscale"], sizes, sl)
    lap("phase 43 (the Matterport-scale world)")
    phase_turn_based_agreement(device, sizes, sl)
    speaker = phase_speaker(device, spk, sl)
    options = phase_options(device, opt)
    scene_out = phase_scene(device, scene)
    regions_out = phase_regions(device, regions)
    lap("phases 23 (agreement), 27, 29-31 (speaker, options, features)")
    with tempfile.TemporaryDirectory() as tmp, cli_bert():
        cli = phase_cli(device, tmp)
        cli["turn_based"] = phase_turn_based(device, tmp, cli)
        cli["classifier"] = phase_classifier(device, tmp, cli)
        cli["oscar"] = phase_oscar(device, tmp)
        phase_datagen(device, tmp)
        cli["speaker"] = phase_speaker_cli(device, tmp, cli)
        cli["no_fused_ln"] = phase_no_fused_ln_cli(device, tmp, cli)
        cli["extract"] = phase_extract_cli(device, tmp, extract)
    lap("phases 22-26, 28, 29, 32 (the CLI)")
    with tempfile.TemporaryDirectory() as tmp:
        dp = phase_dp(tmp)
    lap("phases 33-35 (dp)")
    with tempfile.TemporaryDirectory() as tmp:
        mp = phase_mp(tmp)
    lap("phases 37-38 (tp / sp / cp)")
    mp["kernels"] = mp_kernels
    with tempfile.TemporaryDirectory() as tmp:
        pp = phase_pp(tmp)
    lap("phases 39-40 (pp)")
    say(f"speaker: step {speaker['ms']:.2f} ms (full width), CLI iteration "
        f"{cli['speaker']['ms']:.1f} ms, --aug_data fine-tune iteration "
        f"{cli['speaker']['vp_ms']:.1f} ms, phase 22's viewpoint iteration {cli['vp_ms']:.1f} ms")
    # Kernel times at a path's bucket, where the shape phases did not cover it.
    for key, phase, bucket, rows in (("k1", phase_k1, sl["bucket"], None),
                                     ("k2", phase_k2, None, sl["ln_rows"]),
                                     ("k1b", phase_k1b, tr["bucket"], None),
                                     ("k2b", phase_k2b, None, tr["ln_rows"])):
        if bucket is not None and bucket not in times[key]:
            times[key].update(phase(device, {**attn, "batch": sizes["batch"],
                                             "seqs": (bucket,)}))
        if rows is not None and rows not in times[key]:
            times[key].update(phase(device, {**ln, "rows": (rows,)}))
    say(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    if REHEARSAL:
        return 0
    say(f"nvidia-smi: {smi}")
    line = kernels_line(times, sl, tr, pt, lc, st, rl, cli, options, scene_out, regions_out,
                        dp, mp, pp, t40, bf16)
    line["realscale"] = {"viewpoints": rs["viewpoints"], "table_bytes": rs["table_bytes"],
                         "launches": rs["launches"], "peak_gib": rs["peak_gib"],
                         "t10_step_ms": {k: v["median"] for k, v in rs["t10_step_ms"].items()},
                         "gathers_ms": {k: v.get("gathers_ms") for k, v in rs["gathers"].items()}}
    line["science"] = {"iterations": sci["iters"], "before": sci["before"],
                       "after": sci["after"], "loss_first_50": sci["loss_first"],
                       "loss_last_50": sci["loss_last"],
                       "nav_actions_per_s": sci["actions_per_s"]}
    line["aug_ab"] = {k: ab[k] for k in ("fidelity", "control", "arms", "delta_gp",
                                         "speaker_ce_logged",
                                         "loss_ratios", "iterations", "n_aug", "seconds",
                                         "launches")}
    line["ndh_step_profile"] = {k: tr["profile"][k] for k in (
        "ms_per_step", "busy_ms_per_step", "idle_share", "kernels_per_step",
        "groups_ms_per_step")}
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": dev_info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
