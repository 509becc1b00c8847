#!/usr/bin/env python3
"""Smoke run of the PyTorch port (news_image_caption_tpu_torch) on one
NVIDIA GPU.

Phases, each fatal on failure (exit code 1, no result line):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from news_image_caption_tpu_torch/csrc/;
  3. hold every kernel against its plain PyTorch version on the card at
     the flagship's shapes (bf16; decode shapes for the decode kernels,
     1 to 640 rows (a beam-5 step at B=128) and up to 128 items of five
     queries, every tap count and tied logits for the head and the conv
     block; train-step shapes for flash attention, then its ragged
     tiles, T = 128 over S' = 514 and an item with every key padded, all
     again with the rows offset by 8 in the dropout hash, as a
     data-parallel rank's, and two half batches' masks at row offsets 0
     and B/2 against the whole batch's), and time both, the library's call and an empty launch with CUDA events;
     the four decode kernels twice over: a greedy step's shapes and a
     beam-5 step's at B=16 (80 rows, five queries an item), the latter
     printed as the `beam5_step_b16` JSON line;
  4. serve requests through `flagship_model_builder` at full flagship
     width in bf16 with seeded random weights: three single requests,
     then one of 16 rows. Check the tokens, that every kernel's launch
     count rose by its count per decode step, and the kernel path
     against the plain path (the same weights on the CPU);
  4b. beam-5 search through `TransformerFlattened.generate_beam` with
     the same model and weights, max_len 32 and early exit, at B=16
     (80 rows) and B=128 (640 rows). Check the tokens ([B, 5, 33], bos
     first, ids in the vocab, pad after eos) and the scores (finite,
     best first), that every decode kernel's launches equal its plan's
     count a step times the steps run, each beam's score times
     len^alpha against its tokens re-scored by teacher forcing on the
     card, step 0's candidates against the plain path on the CPU and,
     at B=16, the beams' first tokens of 8-step searches too. Then two
     B=16 searches, early exit and harvest, on a copy of the model
     whose eos row is raised so that its beams finish: the early-exit
     loop stops before max_len, every returned beam ends in eos and the
     beams end at different steps, launches and teacher forcing as
     above. Print request ms, captions/s and device ms a step
     (the `beam5_requests` JSON line, a smoke reading);
  5. train through `flagship_trainer_builder` at full flagship width,
     bf16_o2 with the YAML's dropouts and random weights: 20 steps on
     one synthetic batch of 16. Check that every loss is finite and the
     last is below the first, that no step was skipped, that the flash
     forward and backward ran 8 times a step (4 layers x 2 contexts),
     and the kernel path's deterministic loss against the plain path's
     (the same weights on the CPU); print ms/step, samples/s, peak
     device memory and the flash kernels' share of device time;
  6. the dynamic conv kernel at B=16, T=512, C=1024, H=16 and each of
     the flagship's layer widths K = 3/7/15/31 against its plain
     version within `dynamic_conv_tolerance` (its fused sums' bound plus
     one bf16 unit) and bit for bit (a product of two bf16 values is
     exact in fp32), a second call bit-equal to the first, timed beside
     the plain version, the module's shift and band routes (the faster
     is `library_ms`) and the byte floor; then
     `DynamicConv(method="pallas")` at full flagship width with seeded
     weights: one launch per forward at T=512 (the output against the
     same module on the CPU), none at T=63 (the output equal to the
     shift route's), and a backward that raises;
  7. the evaluate command, `news_image_caption_tpu_torch.cli.main(
     ["evaluate", "configs/goodnews_transformer_roberta.yaml", "--split",
     "test", "--dump-attention", DIR])` with its serialization directory
     in a temporary directory: the flagship in bf16 with random weights
     (the command's own init), the split's 256 records in batches of 16,
     max_len 100, articles padded to 512. Check the files
     (generations.jsonl: 256 enriched records, `checkdiff.
     integrity_check` passes; evaluate-metrics.json: finite BLEU-1..4,
     CIDEr, ROUGE-L; `compute_metrics` over the generations returns its
     keys; every dumped attention row sums to 1 within 1e-2), that every
     decode kernel's launches rose by its count a step (3 / 8 / 4 / 4)
     times the decode steps of all batches, and the first batch against
     the plain path on the CPU (the same weights, rebuilt; its tokens
     first equal to the command's): step-0 log-probs within 0.1, step-0
     tokens agreeing >= 0.75. Print the command's wall seconds, its
     host-clock spans, captions/s and the device ms a step of one
     profiled batch (the `evaluate` JSON line);
  8. the train command, `cli.main(["train", "configs/goodnews_transformer_
     roberta.yaml", "-o", ...])`, at full width and depth (bf16_o2, flash,
     the YAML's dropouts, B=16) with only amounts cut (64 / 32 / 32 train
     / val / test records, 2 epochs, keep 2, log_every 2, t_total 100),
     into a temporary directory removed afterwards; then `evaluate -m
     best` and `-m avg:2` from its checkpoints. Check every logged loss
     finite and no step skipped, val loss falling, meta.json's steps and
     best, the flash launches (8 forward and 8 backward a train step, 8
     forward a val batch), the decode launches (3 / 8 / 4 / 4 times the
     steps the evaluate batches ran), that the decoded model holds best.pt's
     params (or the fp64 mean of the two checkpoints) cast to bf16 tensor
     for tensor, the files as in phase 7, and the best checkpoint's loss
     on 4 rows against the plain path on the CPU. Print the command's
     wall, epochs, step times, input_wait, checkpoint snapshot and write
     times, peak memory, and evaluate's captions/s and steps (the
     `train_command` JSON line);
  9. the serve command, `python -m news_image_caption_tpu_torch.cli serve
     --http-port 0 --max-len 32`, in a subprocess: the flagship at full
     width and depth in bf16 with phase 4's seeded random weights, one
     worker on the card. Read its two JSON lines and the worker's ready
     line (which must name the card); send phase 4's four jobs through
     `CaptioningClient.caption` and two of them through POST /encode, a
     job without `article` (an error reply, and the worker serves the
     next job), 8 B=1 jobs through `caption_stream(window=2)`, 20 B=1
     jobs each beside the same job through phase 4's in-process
     `predict`, and phase 4's B=16 job both ways. Every token array must
     equal the in-process `predict`'s for the same job, element for
     element, and the stream's come in submission order; `stats()` must
     count the jobs served, and the worker's kernel launches (from the
     stats RPC, after the jobs less before them) must be 3 / 8 / 4 / 4
     times the decode steps of the served tokens. SIGTERM must end the
     command with rc 0 within 30 s and leave no sink or worker process.
     Print start to ready, p50 / p90 of the 20 B=1 requests both ways,
     the B=16 request both ways, and, in this process, the host ms of
     `pack`, one socket hop and `unpack` + `stage` for a B=1 and the B=16
     job, their sum over a job's way in (two hops) and that sum over the
     in-process B=1 p50 (the `serve` JSON line, a smoke reading);
  10. the faces, objects, GloVe and no-image variants: first
     `decode_cross_attention` (Q = 1 and 5) and flash attention forward
     and backward (T = 63, p = 0.1) at B=16 over S' = 6 (4 faces or
     objects) and S' = 502 (a GloVe article) with two items whose every
     real row is masked, held and timed as in phase 3; then the train
     command on `configs/nytimes/transformer_faces_objects.yaml` at full
     width and depth with phase 8's cuts (and bf16_o2 with flash), flash
     launches 16 forward and 16 backward a step (4 layers x 4 contexts),
     `evaluate -m best` on 64 test records with the attention dumped
     (`layer{i}_faces`, `layer{i}_obj`), decode launches 3 / 16 / 4 / 4
     a step, every batch's tokens equal to the in-process `generate` of
     the decoded model, one profiled batch and one beam-5 B=16 search;
     then `evaluate` with random weights on 32 records of
     `configs/goodnews/transformer_glove.yaml` (3 / 8 / 4 / 4) and
     `configs/goodnews/no_image.yaml` (3 / 4 / 4 / 4). Print the
     `variants` JSON line: the train step median against phases 5 and
     8's flagship step, captions/s, the device-busy share of a batch,
     the launches and the kernels' times (a smoke reading).
  11. speculative greedy, top-k sampling and the continuous slot pool
     on phase 4's flagship (bf16, seeded random weights): first
     `decode_conv_block` with a position a row against its plain twin
     at N = 16 and 80, K = 3/7/15/31 (rows at 0, K-2, K-1 and past a
     wrap; phase 3's tolerances; a second call bit-equal; one position
     for every row bit for bit the scalar-t kernel), timed beside the
     scalar-t kernel, the plain twin, a library chain and the bound;
     then the greedy pool (16 slots, 8 steps a dispatch, 48 requests in
     three waves, caps of 8 to 32 tokens), the beam pool (8 slots of 5
     rows, 16 requests) and the sampling pool (top-4 at 0.8, 16 seeded
     requests), each request token for token its row of `generate` /
     `generate_beam` run at the pool's row count over the same requests
     (K/V projected a request, as the pool projects them; sampling with
     one generator a row); speculative greedy at B=16, spec_k 4, with
     oracle drafts (the card's greedy caption) and with the synthetic
     article's ids: chunks against steps, the share of tokens equal to
     greedy's (at least 0.891 over 16 steps with oracle drafts, phase
     7's bf16-against-fp32 figure), the drafts never changing the
     tokens; every path's launches from the counts, zeroed just
     before it; then `serve --continuous-slots 8`: phase 9's 20 latency
     jobs one at a time and 8 in flight, tokens equal to an in-process
     pool's, p50 / p90 beside phase 9's plain worker, the worker's
     launches from its stats RPC, SIGTERM (the `continuous` JSON line).
  12. the pointer family (entity gate and copy head), full width, bf16:
     the train command on `configs/nytimes/copy_loss.yaml` (loss weights
     (1, 1, 1)) with phase 8's cuts and the flash switch, 8 flash
     forward a train step and a val batch and 8 backward, every train
     record of `metrics.jsonl` with finite gen / entity / copy losses
     that sum to its loss; `evaluate -m best` on two test batches of
     16, greedy then `speculative_k: 4`, `copied_texts` on every record
     and every record equal to the in-process decode of the checkpoint,
     launches 3 / 8 / 4 / 4 a greedy step (the generated token from the
     band kernel, as the chunk's) and 3 / 8 / 16 / 16 a chunk of 4;
     then the gate forced open (a weight edit in this phase) at B=16:
     every flagged token a
     relevant article id, none twice in a caption, speculative tokens
     and flags equal to k = 1 `pointer_chunk` steps, second calls
     bit-equal; `ContinuousBatcher.for_pointer` with 16 slots, 32
     requests in two waves (caps 8 to 32), each request's tokens and
     flags its row of those steps at 16 rows; one greedy batch each of
     `transformer_only_pointer` (3 / 8 / 4 / 4) and
     `transformer_faces_pointer` (3 / 12 / 4 / 4) with random weights;
     the device ms of a greedy step at B=16 and the heads' share of it
     (the same steps without them); the share of bf16 greedy tokens
     equal to speculative's, which must be 1. The `pointer` JSON line.
  13. the LSTM family (`models/decoder_lstm.py`): the train command on
     `configs/goodnews/lstm_roberta.yaml` (bf16) with phase 8's cuts, no
     kernel launched, every logged loss finite, none skipped, the
     checkpoints' steps; `evaluate -m best` on its 32 test records,
     every record equal to the in-process decode of the checkpoint,
     `band_topk_lse` 3 a step and no other kernel; step 0 of the first
     batch against the plain path on the CPU (the top-5 log-probs and
     the plain path's log-prob of each id the card chose within 0.1);
     one B=16 greedy batch of `configs/goodnews/baseline_glove_lstm.yaml`
     from seeded random weights in bf16 (the same launches, a second
     call bit-equal, step 0 against the plain path), the device ms of a
     step (the `lstm` JSON line).
  14. the Gen-2 family (`models/gen2.py`): the train command on
     `configs/goodnews/gen2_roberta.yaml` (fp32, Noam with its warmup
     cut to 400) with phase 8's cuts, then `evaluate -m best` greedy and
     `speculative_k: 4` as in phase 13, 1 / 6 launches (band /
     attention) a greedy step and a chunk, speculative tokens equal to
     greedy's; step 0 against the plain path; one B=16 batch each of
     `gen2_roberta.yaml` (head size 128) and
     `configs/goodnews/gen2_word.yaml` (head size 64) from seeded random
     weights: greedy, then speculative at spec_k 4, equal token for
     token, launches as above, the device ms of a greedy step;
     `ContinuousBatcher.for_gen2` over the random gen2_roberta model
     with 16 slots and the 32 test requests in two waves (caps 8 to 32),
     each request its row of `generate` over the wave at 16 rows (K/V
     projected a request) (the `gen2` JSON line).
  15. the online pipeline (`models/pipeline.py`: frozen ResNet-152 and
     RoBERTa-large, the 25-layer weighted sum, the flagship's decoder):
     the train command on `configs/goodnews/transformer_weighted_roberta.
     yaml` (bf16) at full width and depth with phase 8's cuts, from the
     synthetic set's raw uint8 images at 224, no kernel launched, every
     logged loss finite, none skipped; the frozen encoders bit-equal
     before and after, `bert_weight` moved, the decoded checkpoint's
     encoders the same values in bf16; `evaluate -m best` greedy on 32
     records, 3 / 8 / 4 / 4 launches a step, every record the in-process
     decode; step 0 against the CPU's plain path on the card's contexts;
     one B=16 greedy batch from seeded random weights: the device ms
     (CUDA events) of the encode's preprocessing, ResNet, RoBERTa and
     weighted sum, the costliest kernels of ResNet, RoBERTa and the
     encode (profiler), a RoBERTa layer's attention by part beside
     PyTorch's fused attention, the device ms of a decode step and the
     busy share of the batch;
     one B=16 batch of `configs/nytimes/transformer_weighted_roberta.
     yaml` (the `pipeline` JSON line).
  16. TGNC (`models/tgnc.py`: the template classifier, 4 trunk layers
     and 5 template heads of kernel 31 mixed before the tied head): the
     train command on `configs/goodnews/joganic_tgnc.yaml` (bf16, the
     BCE template loss) with phase 8's cuts, no kernel launched, then
     `evaluate -m best` as in phase 13 (3 / 18 / 9 / 9 a step); one B=16
     batch from seeded random weights: greedy (launches, a second call
     bit-equal, the device ms a step by CUDA events and the profiler),
     speculative at spec_k 4 with oracle drafts (3 / 18 / 36 / 36 a
     chunk, tokens equal to greedy's), `ContinuousBatcher.for_tgnc`
     with 16 slots (each request its row of `generate` at 16 rows, the
     template logits and K/V computed a request), step 0 against the
     plain path on the CPU (the `tgnc` JSON line).
  17. Gen-1 (`models/gen1.py`): the train command on
     `configs/goodnews/gen1_show_attend_tell.yaml` (fp32, gen1_adam)
     with phase 8's cuts, no kernel launched, `evaluate -m best` (bf16,
     one `band_topk_lse` over the folded head a step), step 0 against
     the plain path; one B=16 batch from seeded random weights: beam 5
     (80 rows, one band launch a step), `sample_with_attention` (the
     maps' rows summing to 1, the tokens `sample`'s), greedy with its
     device ms a step (the `gen1` JSON line).
  18. the data path: `cli.main(["preprocess", ...])` on 96 jsonl
     records naming people and places (64 train, 32 val) with
     `--records-per-shard 32`, ResNet-152 and RoBERTa-large built on the
     card in bf16 with seeded random weights (the records carry no
     image: the reference's zeros; no kernel of the port launched), then
     `materialize(reader=...)` over 32 records with 256 x 256 random
     uint8 images inline; the first batch of 16 of each pass against the
     same encoders in fp32 on the card (relative error in norm within
     `DATA_FEATURE_TOL`), the pixels' features not the zeros'; every
     field of every record read back through `NativeShardLoader` bit
     for bit what was written, a shuffled epoch a permutation of the
     records; the flagship YAML with `dataset: nics_shards` over the
     shards (bf16_o2, flash, B=16, phase 8's amounts) trained 2 epochs:
     losses finite, none skipped, flash 8 + 8 a step and 8 a val batch,
     no decode launch; `evaluate -m best` on the val shard: the files,
     3 / 8 / 4 / 4 launches a step. Print encode ms a batch of 16,
     records/s, the shard reader's batches/s on the host, the train
     step's median and `input_wait` (the `data_commands` JSON line);
  19. the migration path: a flagship-width reference-keyed decoder
     (`tests/torch_tell_decoder.py`, seeded) saved as `best.th`, ported
     by `cli.main(["port", CONFIG, best.th, "-s", DIR])` onto the
     flagship YAML (bf16_o2: best.pt's bf16 params its fp32 master's);
     the ported master's teacher-forced log-probs through the port's
     decoder, fp32 on the card, against the reference-keyed decoder's
     own fp32 forward on the card (|diff| <= 2e-4 + 2e-4 |reference|);
     `evaluate -m best` on 32 test records: the files, 3 / 8 / 4 / 4
     launches a step (the `port_command` JSON line).
  20. detection and captioning of a raw photo through
     `serving/worker.py::full_model_builder` (its defaults, `device=
     "cuda"`, `warmup()` first): `configs/nytimes/transformer_faces.yaml`
     in bf16 from seeded random weights; MTCNN's nets drawn on the CPU
     with their face-class biases raised (`DETECT_FACE_BIAS`), the
     embedder and YOLOv3-SPP (at 256) `full_model_builder`'s seeded random
     weights, all fp32 without TF32; a 480 x 640 uint8 photo with the
     flagship's image [1, 49, 2048] and article [1, 512, 1024]. Each net
     on identical inputs against its CPU copy (`DETECT_NET_TOL`), the
     cascade's per-call counts and boxes against the CPU's, the tokens
     equal to the model's own `generate` on the batch built by hand from
     the detectors' faces, 3 / 12 / 4 / 4 launches a step, step 0
     against the CPU's plain path, the maps (1, T, S' + 2) with rows
     summing to 1, and `ObjectFeatureExtractor` once at 416. Print the
     MTCNN and YOLO stages (host clock), the embedder, YOLO, generate
     and maps (CUDA events), `predict` over 10 calls and the device-busy
     share of a profiled call (the `detect_caption` JSON line).
  21. int8 context K/V and int8 head tables: `decode_cross_attention_int8`
     (kernel A) at B=16 over S' = 514 and 51 with Q = 1 (a greedy step),
     5 (beam-5) and 4 (a speculative chunk), and at B=1 / 128, and
     `band_topk_lse_int8` (kernel B) over the three word tables at 1, 16,
     80 and 640 rows, the K/V and tables quantized by the port's own
     quantizers, each against its plain twin (phase 3's tolerances; a
     second call bit-equal) and timed with its plain twin, its library
     chain (the int8 operands widened and scaled, then the product) and
     the bound; then phase 4's weights through `flagship_model_builder(
     quantize_kv=True, quantize_head=True)`: greedy and beam-5 at B=16
     under each switch and both (the share of tokens equal to the exact
     route's), speculative greedy (spec_k 4, oracle drafts) under each
     (tokens equal to that switch's greedy: 1.0), the greedy pool (16
     slots) and beam pool (8 slots) under both (each request its row of
     the same path at the pool's row count), `serve --quantize-kv
     --quantize-head` answering four jobs equal to the in-process
     builder's, and `evaluate` with `generation.quantize_kv` on phase 7's
     256 records (the files, the first batch the rebuilt model's); every
     path's launches from the counts zeroed just before it, the int8
     variants where their switch is on and the bf16 kernel they stand in
     for never (the `quantize` JSON line).
  22. the profiler window, bf16 first moments, the step loaders and the
     beam layouts: the train command on the flagship YAML (full width
     and depth, bf16_o2, flash; 80 train records, one epoch of 5 steps)
     with `trainer.profile_start: 2, profile_steps: 3`, then `-r` with
     two epochs, resuming at step 5, past the start: each run writes one
     `torch.profiler` trace into `<serialization_dir>/profile` whose
     kernel events hold exactly 3 steps' flash kernels (24 forward, 24
     backward) and whose host spans hold 3 `train_step.forward`, the
     windows opening at steps 2 and 5; 8 flagship train steps from the
     same seeded weights and batches with BertAdam's first moments in
     fp32 and in bf16 (mu stored bf16, losses finite and within rtol
     0.05 of fp32's, `apply` timed on each state); the `Trainer` fed by
     a `FixedStepsLoader` (3 steps an epoch) over phase 18's two train
     shards, stopped after epoch 0 and recovered into epoch 1: its
     batches the uninterrupted stream's, 6 steps; a `TokenBucketBatcher`
     (max_tokens 16384, 16 rows) over the flagship YAML's 128 synthetic
     train records by article length, each batch padded to its bucket,
     through the train step: 8 + 8 flash launches at each of three or
     more bucket lengths; beam-5 at B=16 through `generate_beam` with
     impl "shift", "lazy" and "topk" on phase 4's weights: shift's and
     lazy's tokens equal bit for bit, 0 / 8 / 4 / 20 launches a step
     (the full-vocab head, no band kernel), the share of beams equal to
     topk's and each impl's device ms a step (the `phase22` JSON line).
  23. the decoder's options at the flagship's full width (d = 1024, 16
     heads, FFN 4096, kernels 3/7/15/31, bands 5000/20000/50265, bf16,
     flash, seeded random weights), set A (`conv_type: lightweight`, no
     GLU, raw taps, `normalize_before` with `final_norm`, `conv_dim:
     512`: the plain decode step) and set B (`remat`,
     `tie_adaptive_proj`, `adaptive_softmax_dropout: 0.1`: the kernel
     route): first the ops: flash forward and backward and
     `decode_cross_attention` over an attention without bias slots,
     zero slot or projection biases (S' = S = 49 and 512), and
     `band_topk_lse` over an untied adaptive softmax's `factor: 4` bands
     (1024 / 256 / 64 wide), each against its plain twin at phase 3's
     tolerances; then per set 8 bf16_o2 train steps at B=16 (finite
     losses; 8 + 8 flash launches a step, 16 + 8 with remat), for B the
     dropout-on loss and gradients with and without remat (phase 5's 1%
     and phase 3's gradient tolerance); greedy (16 steps) and beam-5 at
     B=16, launches a greedy step 3 / 8 / 0 / 0 (A) and 3 / 8 / 4 / 4
     (B), step 0 against the fp32 plain path on the CPU (rows whose
     fp32 top-1 leads by more than 0.2 equal, 0.75 of all, the
     agreement printed); set A's speculative greedy (oracle drafts)
     equal to its greedy (the `options` JSON line).
  24. parallelism at one rank: the train command with phase 8's
     overrides plus `trainer.distributed` (one process, a free local
     port) and `trainer.mesh: {data: 1, model: 1}` (so through the split
     code of phase 25 at a model axis of one), with the single-file
     store (`mesh_train_single`) and with `checkpoint_format: sharded`
     (`mesh_train`): one NCCL process group each (no other backend), 96
     forward and 64 backward flash launches, records equal to phase 8's
     bit for bit, the step's epoch medians beside phase 8's,
     directory-per-step checkpoints;
     `evaluate -m best` from the sharded store byte-equal to evaluate of
     the same state through a `.pt` store and to phase 8's; DCP's save
     and load against `torch.save` / `torch.load` of that state, the
     step's gradient all-reduce on NCCL at one rank; RoBERTa-large in
     fp32 (TF32 off) through ring attention over a `context` axis of one
     and the pipeline over a `pipe` axis of one (n_micro 2) against the
     dense encoder within 1e-3 (the `mesh` JSON line).
  25. tensor parallelism's shard forms at the flagship's layer widths
     (D = 1024, 16 heads, F = 4096, bf16, B = 16), every rank of m = 2
     and 4 in this one process, each rank against its plain version on
     its inputs and the ranks together against the whole launch: flash
     forward and backward over a rank's heads with h0 (phase 5's
     shapes, p = 0.1; phase 3's tolerances; out, lse, dq, dk, dv
     concatenated bit for bit); the FFN's partial mode over F/m columns
     at N = 16 and 80 (each fp32 partial within 2e-3 + 1e-3|ref| of the
     plain one; summed, plus b2 and x, within phase 3's tolerance of the
     whole kernel; at one rank bit for bit); `band_topk_lse` over a
     rank's rows of the head band and band 1 (phase 3's tolerances;
     merged, ids and values equal, lse within 1e-6 relative), and the
     30265-row band refusing m = 2 and 4; decode attention over 16/m
     heads (phase 3's tolerance, against both); then the split code at
     a model axis of one, where every form is the unsplit call: phase
     24's train commands (records bit for bit phase 8's) and phase 4's
     model greedy and beam-5 at B=16 (tokens and scores equal to the
     unsplit model's); rank 0's forms at m = 2 timed beside the whole
     launches (the `tensor_parallel` JSON line; `*_shard` and
     `decode_ffn_block_partial` in the kernels line, their launches
     the ranks' calls of this phase).
     Every phase from 3 to 25 also checks that no generic variant
     launched: the flagship in bf16 routes "fast" on all four wrappers.
  26. the generic variants of the four decode kernels
     (`csrc/decode_generic.cu`; fp32, narrow widths, K = 1), TF32 off:
     each against its plain version on the card at the toy's shapes in
     fp32 and tiny_test's in bf16, pointwise layers and other odd widths
     (head sizes 1 to 256), the split attention's edges (S' of one
     and two splits of 64 keys and one either side, 11 splits), the conv
     block's and FFN's product plans' edges (rows 1 to 640 about the
     row tiles of 16, 32 and 80, K = 1 to 32, widths off every tile),
     and the fp32 flagship's greedy (16 rows) and
     beam-5 (80 rows) steps at B=16, which are timed (fp32 1e-5 +
     1e-5 |ref|; bf16 phase 3's tolerances; second calls bit-equal); the
     fp32 flagship decoding greedy and beam-5 at B=16 over 32 steps,
     3 / 8 / 4 / 4 generic launches a step and no fast one, tokens equal
     to the same model's plain path on the card (near-ties reported);
     `serve --task toy` on the card answering five HTTP requests with
     the tokens of `serve --task toy --platform cpu` (its worker
     launching only generic variants); `train configs/tiny_test.yaml`
     on the card, `evaluate -m best` from it and `evaluate
     configs/tiny_pointer.yaml` (bf16 decodes on the generic variants,
     finite metrics) (the `generic` JSON line; the four `*_generic`
     entries of the kernels line with `variant_of`). Phases 3 to 26
     launch none of phase 27's variants.
  27. the generic variants of the two flash kernels
     (`csrc/flash_generic.cu`; fp32, head sizes 1 to 256) and of the two
     int8 variants (`csrc/decode_generic.cu`; fp32, any width), TF32
     off: each against its plain version on the card (fp32 1e-5 +
     1e-5 |ref|, bf16 phase 3's and phase 21's tolerances, second calls
     bit-equal); the generic flash dropping the fast kernel's slots
     (v = I) and, at the fast kernel's shape, its lse within 1e-5 of the
     fast kernel's; the held-row forward's edges (the last S' each row
     count holds and the first past it, the two walks past 16 rows);
     its shard forms at m = 2 bit-equal to the whole
     launch; the fp32 flagship's train step (flash) and greedy and
     beam-5 steps (int8) at B=16, timed; the train command on the
     flagship YAML at trainer.mixed_precision fp32, 8 steps at B=16 and
     a val batch, 8 generic flash launches a step each way and no fast
     one, its first 3 losses within 1e-5 relative of the same command
     with `flash_cross_attention_plain` in the attention's place; `train
     configs/tiny_test.yaml` in bf16 with flash at heads of 4 and 8 and
     `evaluate configs/tiny_test.yaml` with quantize_kv, only generic
     launches; the fp32 flagship decoding greedy and beam-5 at B=16
     under quantize_kv and quantize_head, 3 / 8 / 4 / 4 generic launches
     a step (the int8 ones for the band and the attention), tokens equal
     to the plain path's (the `generic27` JSON line; the four new
     `*_generic` entries of the kernels line). Phases 26 and 27 print
     the redesigned kernels' step times (the generic flash forward, the
     generic attention and its int8 instantiation, the generic conv
     block and FFN) beside their plain versions, library calls, bounds
     and times before the redesign.
The line before the last is a JSON summary of the kernels (`launches`
over the main paths, `launches_by_path` split by path, the serve
command's counted in its worker); the last is
{"ok": true, "device": {...}}.

Run from the repository root: python3 chip_smoke.py

`python3 chip_smoke.py --serving-latency N` instead measures the
flagship's request latency over N requests, greedy at B=1 and B=16 and
beam-5 at B=16 and B=128, and profiles one request of each (see
`latency_mode`); it prints no result line.

`python3 chip_smoke.py --mesh-overhead [ORDER]` instead reads what the
data-parallel step costs at one rank (see `mesh_overhead_mode`): the
train command of phase 8's YAML at 20 steps, without and with
`trainer.mesh` in ORDER (default pmpm), then one profiled window of
each; it prints no result line.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(res.returncode == 0 and res.stdout.strip() != "",
          f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of fn() on the card, L2-cold: CUDA
    events around each call, with a 128 MB buffer overwritten before
    it. A flagship decode step reads 260 MB (B=1) to 400 MB (B=16) of
    weights and context K/V, five to eight times the 50 MB L2, so the
    main path finds each kernel's operands in device memory. A spin of
    about 1 ms on the card after the overwrite lets the host enqueue
    all of fn() before the start event fires, so the host's time in
    the wrapper stays out of the reading."""
    import torch
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(2_000_000)       # clock cycles
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def within(got, want, atol: float, rtol: float):
    """(max |got - want|, whether |got - want| <= atol + rtol |want|)."""
    d = (got.float() - want.float()).abs()
    return d.max().item(), bool((d <= atol + rtol * want.float().abs()).all())


HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (data sheet)
PEAK_OPS_PER_S = {"bf16": 989e12,  # dense tensor-core rate, bf16 inputs
                  "fp32": 67e12}   # fp32 outside the tensor cores


class Tally:
    """One kernel's entry of the `kernels` line, summed over the calls
    of one step: the largest error, the kernel's, the plain version's
    and the library call's device times, and the bound (the larger of
    the bytes every input and output holds over the card's memory rate
    and the operations over the card's peak rate for their type)."""

    def __init__(self, rate: str = "bf16"):
        self.rate = rate
        self.errs = []
        self.ms = self.plain_ms = self.bytes_ms = self.ops_ms = 0.0
        self.library_ms = None

    def add(self, tensors, ops: float, ms: float, plain_ms: float,
            library_ms=None, calls: int = 1) -> str:
        """Count `calls` calls that move `tensors` once each and do
        `ops` operations; returns a line for the log."""
        nbytes = sum(t.numel() * t.element_size() for t in tensors)
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        o_ms = ops / PEAK_OPS_PER_S[self.rate] * 1e3
        self.ms += calls * ms
        self.plain_ms += calls * plain_ms
        self.bytes_ms += calls * b_ms
        self.ops_ms += calls * o_ms
        line = (f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound"
                f" {max(b_ms, o_ms):.4f} ms ({nbytes / 1e6:.2f} MB,"
                f" {ops / 1e6:.0f} MFLOP)")
        if library_ms is not None:
            self.library_ms = (self.library_ms or 0.0) + calls * library_ms
            line += f", library {library_ms:.4f} ms"
        return line

    def result(self) -> dict:
        return dict(max_abs_err=max(self.errs), ms=self.ms,
                    plain_ms=self.plain_ms,
                    bound_ms=max(self.bytes_ms, self.ops_ms),
                    bound_by=("bytes" if self.bytes_ms >= self.ops_ms
                              else "operations"),
                    library_ms=self.library_ms)


def sdpa(torch, q, k, v, bias, H: int, dropout_p: float = 0.0):
    """The library yardstick of the attention kernels: PyTorch's
    scaled_dot_product_attention on [B, H, Q, dh] views, the key bias
    as an additive mask, scale 1 (q is pre-scaled), the heads gathered
    into [B, Q, E] as the kernels write them. Timed here only; the port
    never calls it."""
    B, Q, E = q.shape
    S = k.shape[1]
    heads = lambda t, n: t.view(B, n, H, E // H).transpose(1, 2)
    return torch.nn.functional.scaled_dot_product_attention(
        heads(q, Q), heads(k, S), heads(v, S),
        attn_mask=bias.to(q.dtype)[:, None, None, :], dropout_p=dropout_p,
        scale=1.0).transpose(1, 2).reshape(B, Q, E)


def attention_case(torch, xattn, what: str, q, k, v, bias, H: int,
                   tally=None, calls: int = 1) -> float:
    """`decode_cross_attention` at these inputs against its plain version
    (0.02 abs + 0.02 rel: one bf16 rounding of a probability or the
    output) and a second call bit for bit. With `tally`, add the error
    and `calls` calls of the kernel's time beside its plain version's and
    scaled_dot_product_attention's. Returns the largest error."""
    got = xattn.decode_cross_attention(q, k, v, bias, H)
    again = xattn.decode_cross_attention(q, k, v, bias, H)
    want = xattn.decode_cross_attention_plain(q, k, v, bias, H)
    torch.cuda.synchronize()
    e, ok = within(got, want, 0.02, 0.02)
    same = bool(torch.equal(got, again))
    print(f"  decode_cross_attention {what}: {e:.3g} (tol 0.02 + 0.02|ref|),"
          f" repeated call bit-equal {same}", flush=True)
    check(ok, f"decode_cross_attention {what} disagrees")
    check(same, f"decode_cross_attention {what}: two calls on the same"
          " inputs differ")
    if tally is not None:
        B, Q, D = q.shape
        tally.errs.append(e)
        line = tally.add(
            (q, k, v, bias, got), 4.0 * B * Q * k.shape[1] * D,
            time_ms(lambda: xattn.decode_cross_attention(q, k, v, bias, H)),
            time_ms(lambda: xattn.decode_cross_attention_plain(q, k, v, bias,
                                                               H)),
            time_ms(lambda: sdpa(torch, q, k, v, bias, H)), calls=calls)
        print(f"    time {what}: {line}")
    return e


def kernel_phase(torch, ops):
    """Phase 3. Returns two {kernel: dict(max_abs_err, ms, plain_ms,
    bound_ms, bound_by, library_ms)}, the times summed over one decode
    step at batch 16 (all layers): a greedy step (16 rows, one query an
    item) and a beam-5 step (80 rows, five queries an item)."""
    band, xattn, blocks, _build = ops
    F_ = torch.nn.functional
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(bf16)

    N, D, H, F = 16, 1024, 16, 4096
    NB = 5 * N                   # the rows of a beam-5 step at B=16
    NB128 = 5 * 128              # and at B=128, held but not timed
    results = {}
    beam = {name: Tally() for name in ("band_topk_lse",
                                       "decode_cross_attention",
                                       "decode_conv_block",
                                       "decode_ffn_block")}

    # An empty kernel's launch under the same method: the fixed cost in
    # every time below.
    empty = _build.function("nic_empty_launch", [_build.P])
    stream = torch.cuda.current_stream().cuda_stream
    print(f"  empty kernel launch: {time_ms(lambda: empty(stream)):.4f} ms"
          " (CUDA events, after the L2 flush and the spin)", flush=True)

    # band_topk_lse: the head band [table0; class_projᵀ] (5002 rows,
    # selectable below 5000), the two tails and two ragged single tiles,
    # at 1, 16, 80 and 640 (beam-5 steps at B=16 and B=128) rows. Tolerance: one bf16
    # rounding of a logit of magnitude < 8 (2^-5 = 0.03125), for the
    # values and for the plain logit at each id the kernel chose.
    # Library yardstick, a chain of three calls: the bf16 product,
    # logsumexp, topk. The greedy tally's times are N = 16, k = 1; the
    # beam tally's N = 80, k = 5.
    tally = results["band_topk_lse"] = Tally()
    for V, sel in ((5002, 5000), (15000, 15000), (30265, 30265), (63, 63),
                   (65, 60)):
        table = rn(V, D, scale=D ** -0.5)
        for n in (1, N, NB, NB128):
            x = rn(n, D)
            logits = (x.float() @ table.float().T).to(bf16).float()
            worst = [0.0, 0.0, 0.0, 1.0]
            for k in (1, 5, 16):
                kv, ki, kl = band.band_topk_lse(x, table, k, sel)
                again = band.band_topk_lse(x, table, k, sel)
                pv, pi, pl = band.band_topk_lse_plain(x, table, k, sel)
                torch.cuda.synchronize()
                e_v, ok_v = within(kv, pv, 0.03125, 0.0)
                e_l, ok_l = within(kl, pl, 1e-3, 1e-4)
                at_ids = torch.gather(logits, 1, ki.long())
                e_i, ok_i = within(at_ids, pv, 0.03125, 0.0)
                agree = (ki == pi).float().mean().item()
                ok_sel = bool((ki < sel).all()) and bool((ki >= 0).all())
                same = all(torch.equal(a, b)
                           for a, b in zip((kv, ki, kl), again))
                check(ok_v and ok_l and ok_i and ok_sel,
                      f"band_topk_lse V={V} N={n} k={k} disagrees with its"
                      " plain twin")
                check(same, f"band_topk_lse V={V} N={n} k={k}: two calls on"
                      " the same inputs differ")
                worst = [max(worst[0], e_v), max(worst[1], e_l),
                         max(worst[2], e_i), min(worst[3], agree)]
                if n == N:
                    tally.errs += [e_v, e_l]
                if n == NB and k == 5:
                    beam["band_topk_lse"].errs += [e_v, e_l]
                    out5 = (kv, ki, kl)
            print(f"  band_topk_lse V={V} sel={sel} N={n} k=1/5/16: values"
                  f" {worst[0]:.3g}, lse {worst[1]:.3g}, plain logit at chosen"
                  f" ids {worst[2]:.3g} (tol 0.03125 / 1e-3+1e-4|lse| /"
                  f" 0.03125), ids equal {worst[3]:.3f}, repeated calls"
                  " bit-equal", flush=True)

            def library(k=1, x=x):
                lg = x @ table.T
                return (torch.logsumexp(lg.float(), -1),
                        torch.topk(lg[:, :sel], k))
            if n == N and V > 1000:
                line = tally.add(
                    (x, table, kv[:, :1], ki[:, :1], kl), 2.0 * N * V * D,
                    time_ms(lambda: band.band_topk_lse(x, table, 1, sel)),
                    time_ms(lambda: band.band_topk_lse_plain(x, table, 1,
                                                             sel)),
                    time_ms(library))
                print(f"    time N={N} k=1: {line}")
                t5 = time_ms(lambda: band.band_topk_lse(x, table, 5, sel))
                print(f"    time N={N} k=5: kernel {t5:.4f} ms, library"
                      f" {time_ms(lambda: library(5)):.4f} ms")
            if n == NB and V > 1000:
                line = beam["band_topk_lse"].add(
                    (x, table, *out5), 2.0 * NB * V * D,
                    time_ms(lambda: band.band_topk_lse(x, table, 5, sel)),
                    time_ms(lambda: band.band_topk_lse_plain(x, table, 5,
                                                             sel)),
                    time_ms(lambda: library(5)))
                print(f"    time N={NB} k=5 (a beam-5 step at B=16): {line}")
    # Ties: copies of one row in one tile, in two tiles of one block and
    # in other blocks; x is that row, so the copies are the largest
    # logits. The ids must be the plain version's exactly, lowest first.
    V, src, copies = 30265, 20000, [7, 70, 64 * 132 + 5, 64 * 133 + 9, 19999,
                                    30264]
    table = rn(V, D, scale=D ** -0.5)
    table[copies] = table[src].clone()
    x = (table[src] * 8).expand(N, D).contiguous()
    kv, ki, _ = band.band_topk_lse(x, table, 7)
    pv, pi, _ = band.band_topk_lse_plain(x, table, 7)
    torch.cuda.synchronize()
    check(ki.tolist() == [sorted(copies + [src])] * N
          and bool(torch.equal(ki, pi)),
          f"band_topk_lse: tied logits did not go to the lowest ids:"
          f" {ki[0].tolist()} against {pi[0].tolist()}")
    print(f"  band_topk_lse ties (7 equal rows over tiles and blocks): ids"
          f" {ki[0].tolist()} equal to the plain version's", flush=True)

    # decode_cross_attention: article (S' = 514) and image (S' = 51)
    # contexts, padded keys masked with -1e9. Tolerance 0.02 abs + 0.02
    # rel: one bf16 rounding of a probability or the output. The timed
    # calls are a greedy step's (Q = 1, B = 16) and a beam-5 step's
    # (Q = 5, B = 16), one per layer and context, and B = 1 for the log;
    # a beam-5 step at B = 128 (Q = 5) is held, not timed. Library
    # yardstick: scaled_dot_product_attention.
    tally = results["decode_cross_attention"] = Tally()

    def case(B, Q, S, timed=None, one_key=False):
        k_, v_ = rn(B, S, D), rn(B, S, D)
        bias = torch.zeros(B, S, device=dev)
        bias[B // 2:, S // 2:S - 2] = -1e9      # padded context slots
        if one_key:                             # item 0 sees one key only
            bias[0] = -1e9
            bias[0, S // 3] = 0.0
        q = rn(B, Q, D, scale=0.125)
        what = (f"B={B} Q={Q} S'={S}"
                + (" (item 0: one key unmasked)" if one_key else ""))
        e = attention_case(torch, xattn, what, q, k_, v_, bias, H, timed,
                           calls=4 if B == N else 0)
        tally.errs.append(e)

    for S in (514, 51):
        case(N, 1, S, timed=tally)
        case(N, 5, S, timed=beam["decode_cross_attention"])
        case(128, 5, S)
        case(N, 16, S)
        case(1, 1, S, timed=tally)
        case(1, 5, S)
        case(1, 16, S)
    for S in (1, 63, 65):
        case(N, 1, S)
        case(1, 16, S)
    case(N, 5, 514, one_key=True)
    case(1, 1, 51, one_key=True)

    # decode_conv_block: K = 2/3/7/15/31 at 1, 5, 16, 80 and 640 rows, at t
    # before, at and past the ring filling. Tolerance 0.02 (h) and 0.05
    # (y) abs + rel, the reference tests' bf16 tolerances. The tallies'
    # times are N = 16 (greedy) and N = 80 (beam) at the flagship's K =
    # 3/7/15/31, the taps packed once as the model does. Library
    # yardstick, a chain in bf16: linear, glu, linear, softmax, gather +
    # einsum, linear, add.
    tally = results["decode_conv_block"] = Tally()
    w1, b1 = rn(D, 2 * D, scale=D ** -0.5), rn(2 * D, scale=0.05)
    w2, b2 = rn(D, D, scale=D ** -0.5), rn(D, scale=0.05)
    for K in (2, 3, 7, 15, 31):
        wl = rn(D, H * K, scale=0.05)
        taps = blocks.pack_taps(wl, H)
        for n in (1, 5, N, NB, NB128):
            x = rn(n, D)
            cache = rn(K - 1, n, D, scale=0.5)
            worst = [0.0, 0.0]
            for t in (0, K - 2, 2 * K + 3):
                args = (x, cache, t, w1, b1, wl, w2, b2, H)
                y, h = blocks.decode_conv_block(*args, taps=taps)
                y2, h2 = blocks.decode_conv_block(*args, taps=taps)
                py, ph = blocks.decode_conv_block_plain(*args)
                torch.cuda.synchronize()
                e_h, ok_h = within(h, ph, 0.02, 0.02)
                e_y, ok_y = within(y, py, 0.05, 0.05)
                check(ok_h and ok_y,
                      f"decode_conv_block N={n} K={K} t={t} disagrees")
                check(bool(torch.equal(y, y2)) and bool(torch.equal(h, h2)),
                      f"decode_conv_block N={n} K={K} t={t}: two calls on"
                      " the same inputs differ")
                worst = [max(worst[0], e_h), max(worst[1], e_y)]
                if n in (N, NB):
                    (tally if n == N else beam["decode_conv_block"]).errs += [
                        e_h, e_y]
            print(f"  decode_conv_block N={n} K={K} t=0/{K - 2}/{2 * K + 3}:"
                  f" h {worst[0]:.3g}, y {worst[1]:.3g} (tol 0.02 / 0.05, abs"
                  " + rel), repeated calls bit-equal", flush=True)
            if n not in (N, NB) or K == 2:
                continue
            slots = (t + torch.arange(K - 1, device=dev)) % (K - 1)

            def library():
                hh = F_.glu(F_.linear(x, w1.T, b1), dim=-1)
                p = torch.softmax(F_.linear(hh, wl.T).view(n, H, K), dim=-1)
                hist = torch.cat([cache[slots], hh[None]]).view(K, n, H, D // H)
                conv = torch.einsum("nhk,knhr->nhr", p, hist).reshape(n, D)
                return F_.linear(conv, w2.T, b2) + x, hh
            line = (tally if n == N else beam["decode_conv_block"]).add(
                (x, cache, w1, b1, wl, w2, b2, y, h),
                2.0 * n * D * (2 * D + H * K + D) + 2.0 * n * D * K,
                time_ms(lambda: blocks.decode_conv_block(*args, taps=taps)),
                time_ms(lambda: blocks.decode_conv_block_plain(*args)),
                time_ms(library))
            print(f"    time N={n} K={K}: {line}")

    # decode_ffn_block at N = 640, 80, 16, 5 and 1 rows. Tolerance 0.02
    # abs + rel. The timed calls are N = 16 (greedy) and N = 80 (beam,
    # five launches of 16 rows in the call), one per layer; N = 640 (40
    # launches) is held, not timed. Library yardstick,
    # a chain of four calls in bf16: linear, relu, linear, add.
    tally = results["decode_ffn_block"] = Tally()
    f1, fb1 = rn(D, F, scale=D ** -0.5), rn(F, scale=0.05)
    f2, fb2 = rn(F, D, scale=F ** -0.5), rn(D, scale=0.05)
    x = rn(NB128, D)
    for n in (NB128, NB, N, 5, 1):
        args = (x[:n].contiguous(), f1, fb1, f2, fb2)
        y = blocks.decode_ffn_block(*args)
        again = blocks.decode_ffn_block(*args)
        py = blocks.decode_ffn_block_plain(*args)
        torch.cuda.synchronize()
        e, ok = within(y, py, 0.02, 0.02)
        same = bool(torch.equal(y, again))
        print(f"  decode_ffn_block N={n} C={D} F={F}: {e:.3g} (tol 0.02 +"
              f" 0.02|ref|), repeated call bit-equal {same}", flush=True)
        check(ok, f"decode_ffn_block N={n} disagrees with its plain twin")
        check(same, f"decode_ffn_block N={n}: two calls on the same inputs"
              " differ")
        if n == NB128:
            continue
        into = beam["decode_ffn_block"] if n == NB else tally
        into.errs.append(e)
        if n in (NB, N, 1):
            xs = args[0]
            line = into.add(
                (*args, y), 4.0 * n * D * F,
                time_ms(lambda: blocks.decode_ffn_block(*args)),
                time_ms(lambda: blocks.decode_ffn_block_plain(*args)),
                time_ms(lambda: F_.linear(torch.relu(
                    F_.linear(xs, f1.T, fb1)), f2.T, fb2) + xs),
                calls=0 if n == 1 else 4)
            print(f"    time N={n}: {line}")
    return ({name: t.result() for name, t in results.items()},
            {name: t.result() for name, t in beam.items()})


def flash_errors(got, want):
    """([errors], [within tolerance]) of flash's (out, lse, dq, dk, dv)
    against the plain versions'. out: one bf16 rounding of a probability
    or of the output (0.02 abs + rel); lse fp32 (1e-3 + 1e-5 rel);
    gradients: a bf16 rounding of ds summed over up to 514 terms, 2% of
    the item's largest entry plus 2% relative. (Of an item whose keys
    are all padded the saved lse is -1e9, which swallows log S: its
    probs are 1 in the backward, here as in the reference, and its
    gradients S times larger than its neighbours'.)"""
    cases = [within(got[0], want[0], 0.02, 0.02),
             within(got[1], want[1], 1e-3, 1e-5)]
    cases += [within(a, b, 0.02 * b.float().abs().amax((1, 2), True), 0.02)
              for a, b in zip(got[2:], want[2:])]
    return [e for e, _ in cases], [ok for _, ok in cases]


def flash_case(torch, flash, what: str, q, k, v, g, bias, seed, H: int,
               p: float, tallies=None, calls: int = 1, row0: int = 0) -> None:
    """Flash attention forward and backward at these inputs against their
    plain versions, and a second call bit for bit, the batch's first
    global row `row0` in the dropout hash. With `tallies`
    ({"flash_attention_fwd": Tally, "flash_attention_bwd": Tally}), add
    the errors and `calls` calls of each kernel's time beside its plain
    version's and the library call's (scaled_dot_product_attention with
    dropout_p = p, and its backward through autograd)."""
    fargs = (q, k, v, bias, seed, H, p, None, row0)
    out, lse = flash.flash_attention_fwd(*fargs)
    grads = flash.flash_attention_bwd(q, k, v, bias, seed, lse, g, H, p,
                                      row0=row0)
    out2, lse2 = flash.flash_attention_fwd(*fargs)
    grads2 = flash.flash_attention_bwd(q, k, v, bias, seed, lse, g, H, p,
                                       row0=row0)
    torch.cuda.synchronize()
    pout, plse = flash.flash_attention_fwd_plain(*fargs)
    pgrads = flash.flash_attention_bwd_plain(q, k, v, bias, seed, plse, g, H,
                                             p, row0=row0)
    errs, oks = flash_errors((out, lse, *grads), (pout, plse, *pgrads))
    same = (torch.equal(out, out2) and torch.equal(lse, lse2)
            and all(torch.equal(a, b) for a, b in zip(grads, grads2)))
    print(f"  flash attention {what}: out {errs[0]:.3g}, lse"
          f" {errs[1]:.3g}, dq {errs[2]:.3g}, dk {errs[3]:.3g}, dv"
          f" {errs[4]:.3g} (tol 0.02+0.02|ref| / 1e-3+1e-5|ref| / 0.02"
          f" max|ref|+0.02|ref|), repeated call bit-equal {same}",
          flush=True)
    check(all(oks), f"flash attention {what} disagrees with its plain twin")
    check(same, f"flash attention {what}: two calls on the same inputs"
          " differ")
    if tallies is None:
        return
    fwd, bwd = tallies["flash_attention_fwd"], tallies["flash_attention_bwd"]
    fwd.errs += errs[:2]
    bwd.errs += errs[2:]
    # The library's forward and, over one retained graph, its backward.
    lq, lk, lv = (t.detach().requires_grad_() for t in (q, k, v))
    lout = sdpa(torch, lq, lk, lv, bias, H, p)
    B, T, E = q.shape
    flops = 4.0 * B * T * k.shape[1] * E
    line = fwd.add(
        (q, k, v, bias, seed, out, lse), flops,
        time_ms(lambda: flash.flash_attention_fwd(*fargs)),
        time_ms(lambda: flash.flash_attention_fwd_plain(*fargs)),
        time_ms(lambda: sdpa(torch, q, k, v, bias, H, p)), calls=calls)
    print(f"    time flash_attention_fwd {what}: {line}")
    # Backward: the scores again, dp, dv, dq and dk: five products.
    line = bwd.add(
        (q, k, v, bias, seed, lse, g, *grads), 2.5 * flops,
        time_ms(lambda: flash.flash_attention_bwd(q, k, v, bias, seed, lse,
                                                  g, H, p, row0=row0)),
        time_ms(lambda: flash.flash_attention_bwd_plain(
            q, k, v, bias, seed, plse, g, H, p, row0=row0)),
        time_ms(lambda: torch.autograd.grad(lout, (lq, lk, lv), g,
                                            retain_graph=True)), calls=calls)
    print(f"    time flash_attention_bwd {what}: {line}")


def flash_phase(torch, flash):
    """Phase 3, flash attention. The dropout mask against the plain
    generator; then the flagship train step's shapes, timed: q
    [16, 63, 1024] (pre-scaled), k/v [16, S', 1024] with S' = 514
    (article) and 51 (image), half the items padded, p = 0.1 and one
    seed, so kernel and plain version draw the same mask; then ragged
    query and key tiles, T = 128 over S' = 514 included, with an item
    whose keys are all padded. Every case is held against the plain
    versions and repeated bit for bit. Returns {kernel: dict(max_abs_err,
    ms, plain_ms, bound_ms, bound_by, library_ms)}: the largest error at
    the train step's shapes and the times summed over one train step's
    calls (4 layers x 2 contexts). Library yardstick:
    scaled_dot_product_attention with dropout_p = 0.1, and its backward
    through autograd. Then, for a data-parallel rank's batch, the mask of
    two half batches with their first rows as offsets against the whole
    batch's, and every untimed case again with rows offset by 8."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    bf16 = torch.bfloat16

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(bf16)

    # The mask itself: v = I in every head makes the output the dropped
    # probability matrix, so its zeros are the dropped slots. One tile,
    # then three T tiles and two key tiles in two heads.
    seed = torch.tensor([5], dtype=torch.int32, device=dev)
    for B, T, S, H in ((2, 8, 64, 1), (2, 130, 128, 2)):
        eye = torch.eye(S, device=dev, dtype=bf16).repeat(B, 1, H)
        out, _ = flash.flash_attention_fwd(
            rn(B, T, H * S, scale=0.3), rn(B, S, H * S), eye,
            torch.zeros(B, S, device=dev), seed, H, 0.25)
        keep = flash.dropout_keep(seed, B, H, T, S, 0.25)
        kept = (out.float() > 0).view(B, T, H, S).transpose(1, 2)
        same = bool(torch.equal(kept, keep))
        print(f"  flash dropout mask T={T} S'={S} H={H}, kernel vs plain"
              f" generator: identical {same}, kept"
              f" {keep.float().mean().item():.4f} (p = 0.25)", flush=True)
        check(same, "the flash kernel's dropout mask differs from the plain"
              " one")
        # Two ranks' halves, each hashing from its first global row.
        halves = [flash.flash_attention_fwd(
            rn(B // 2, T, H * S, scale=0.3), rn(B // 2, S, H * S),
            eye[:B // 2], torch.zeros(B // 2, S, device=dev), seed, H, 0.25,
            row0=r0)[0] for r0 in (0, B // 2)]
        kept = (torch.cat(halves).float() > 0).view(B, T, H, S).transpose(
            1, 2)
        same = bool(torch.equal(kept, keep))
        print(f"  flash dropout mask of two half batches at row offsets 0"
              f" and {B // 2}: the whole batch's {same}", flush=True)
        check(same, "the flash kernel's mask with a row offset differs from"
              " the whole batch's")

    E, H, p = 1024, 16, 0.1
    seed = torch.tensor([1234], dtype=torch.int32, device=dev)
    res = {"flash_attention_fwd": Tally(), "flash_attention_bwd": Tally()}

    def case(B, T, S, timed=False, row0=0):
        # q as the layer gives it: unit-scale projections times 64^-0.5.
        q, k, v = rn(B, T, E, scale=0.125), rn(B, S, E), rn(B, S, E)
        g = rn(B, T, E, scale=0.1)
        bias = torch.zeros(B, S, device=dev)
        bias[B // 2:, S // 2:max(S - 2, S // 2)] = -1e9
        if not timed:
            bias[0] = -1e9                  # an item with every key padded
        flash_case(torch, flash, f"B={B} T={T} S'={S} p={p}"
                   + (f" row0={row0}" if row0 else ""), q, k, v, g, bias,
                   seed, H, p, res if timed else None, calls=4, row0=row0)

    for S in (514, 51):
        case(16, 63, S, timed=True)
    for row0 in (0, 8):
        if row0:
            for S in (514, 51):
                case(16, 63, S, row0=row0)
        for T in (2, 63, 64, 65, 128):
            for S in (1, 63, 65, 514):
                case(2, T, S, row0=row0)
    return {name: t.result() for name, t in res.items()}


def make_job(rng, B: int, article_lens):
    from news_image_caption_tpu_torch.config import (FLAGSHIP,
                                                     FLAGSHIP_ARTICLE_LEN,
                                                     FLAGSHIP_IMAGE_LEN)
    P, S = FLAGSHIP_IMAGE_LEN, FLAGSHIP_ARTICLE_LEN
    article_mask = np.arange(S)[None, :] >= np.asarray(article_lens)[:, None]
    return {
        "image": rng.randn(B, P, FLAGSHIP["image_dim"]).astype(np.float32),
        "image_mask": np.zeros((B, P), bool),
        "article": rng.randn(B, S, FLAGSHIP["article_dim"]).astype(np.float32),
        "article_mask": article_mask,
    }


def stage_batch(torch, job, device) -> dict:
    """A job's arrays as the model's batch on `device`, features bf16."""
    batch = {k: torch.as_tensor(v).to(device) for k, v in job.items()}
    batch["image"] = batch["image"].bfloat16()
    batch["article"] = batch["article"].bfloat16()
    return batch


def decode_steps(tokens: np.ndarray, eos: int, max_len: int) -> int:
    """Steps an early-exit greedy loop ran for these tokens: until every
    row had emitted eos (its column), or max_len."""
    ends = []
    for row in tokens:
        hits = np.flatnonzero(row[1:] == eos)
        if hits.size == 0:
            return max_len
        ends.append(int(hits[0]) + 1)
    return max(ends)


def check_tokens(tokens: np.ndarray, B: int, cfg, vocab: int) -> None:
    check(tokens.shape == (B, cfg.max_len + 1),
          f"tokens shape {tokens.shape}, expected {(B, cfg.max_len + 1)}")
    check(bool((tokens[:, 0] == cfg.bos_id).all()), "bos is not first")
    check(bool(((tokens >= 0) & (tokens < vocab)).all()), "id out of vocab")
    for row in tokens:
        hits = np.flatnonzero(row[1:] == cfg.eos_id)
        if hits.size:
            check(bool((row[hits[0] + 2:] == cfg.pad_id).all()),
                  "a row continues after eos")


def greedy_launches_a_step(n_contexts: int = 2) -> dict:
    """Per greedy decode step of the flagship's decoder: one band call
    per adaptive band, one attention per layer and context (image and
    article: 2; a variant attends 1 to 4), one conv and FFN block per
    layer: 3 / 8 / 4 / 4 for the flagship."""
    from news_image_caption_tpu_torch.config import FLAGSHIP
    n_layers = FLAGSHIP["num_layers"]
    return {"band_topk_lse": len(FLAGSHIP["cutoff"]),
            "decode_cross_attention": n_contexts * n_layers,
            "decode_conv_block": n_layers, "decode_ffn_block": n_layers}


def serving_phase(torch, counted):
    """Phase 4. Returns (the main-path launch count of each kernel, the
    server's predict, the four jobs, their tokens)."""
    from news_image_caption_tpu_torch.config import FLAGSHIP
    from news_image_caption_tpu_torch.models.captioner import \
        TransformerFlattened
    from news_image_caption_tpu_torch.serving.worker import \
        flagship_model_builder

    t0 = time.perf_counter()
    predict = flagship_model_builder("cuda", batch_size=1, max_len=32,
                                     early_exit=True, seed=0)
    predict.warmup()
    cfg = predict.config
    print(f"  model built and warmed up in {time.perf_counter() - t0:.1f} s,"
          f" peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          " GiB", flush=True)
    rng = np.random.RandomState(0)
    jobs = [make_job(rng, 1, [512]), make_job(rng, 1, [300]),
            make_job(rng, 1, [40]),
            make_job(rng, 16, rng.randint(20, 513, size=16))]
    per_step = greedy_launches_a_step()

    for fn in counted.values():
        fn.launches = 0
    steps, outputs = 0, []
    for job in jobs:
        B = job["image"].shape[0]
        t = time.perf_counter()
        tokens = predict(job)["tokens"]
        lat = (time.perf_counter() - t) * 1e3
        check_tokens(tokens, B, cfg, FLAGSHIP["vocab_size"])
        n = decode_steps(tokens, cfg.eos_id, cfg.max_len)
        steps += n
        outputs.append(tokens)
        print(f"  request B={B}: {lat:.1f} ms, {n} decode steps,"
              f" tokens[0,:8] {tokens[0, :8].tolist()}", flush=True)
    launches = {name: fn.launches for name, fn in counted.items()}
    for name, n in launches.items():
        print(f"  {name}: {n} launches over {steps} steps"
              f" (expected {per_step[name]} per step)")
        check(n == per_step[name] * steps and n > 0,
              f"{name} launched {n} times, expected {per_step[name] * steps}")

    # Kernel path vs plain path: the same weights, the plain twins on
    # the CPU, on the 16-row request.
    job = jobs[-1]
    gpu_batch, cpu_batch = stage_batch(torch, job, "cuda"), stage_batch(
        torch, job, "cpu")
    tok_k, lp_k = predict.model.generate(gpu_batch, cfg, predict.weights)
    check(bool(np.array_equal(tok_k.cpu().numpy(), outputs[-1])),
          "generate and predict disagree on the same request")
    cpu_model = TransformerFlattened(
        decoder=copy.deepcopy(predict.model.decoder).to("cpu"))
    t = time.perf_counter()
    tok_p, lp_p = cpu_model.generate(cpu_batch, cfg)
    print(f"  plain path on the CPU: {time.perf_counter() - t:.1f} s")
    lp_k, tok_k = lp_k.cpu(), tok_k.cpu()
    check(bool(torch.isfinite(lp_k).all()), "non-finite log-probs")
    e0 = (lp_k[:, 0] - lp_p[:, 0]).abs().max().item()
    agree0 = (tok_k[:, 1] == tok_p[:, 1]).float().mean().item()
    agree = (tok_k[:, 1:] == tok_p[:, 1:]).float().mean().item()
    print(f"  step-0 top-1 log-prob, kernel vs plain path: max |diff| {e0:.4g}"
          f" (tol 0.1); step-0 token agreement {agree0:.3f} (min 0.75);"
          f" token agreement over the decode {agree:.3f}", flush=True)
    check(e0 <= 0.1, "step-0 log-probs of the kernel and plain paths differ")
    check(agree0 >= 0.75, "step-0 tokens of the kernel and plain paths differ")
    return launches, predict, jobs, outputs


def check_beams(tokens: np.ndarray, scores: np.ndarray, B: int, cfg,
                vocab: int) -> None:
    """Beam output: tokens [B, K, max_len + 1] as `check_tokens` holds
    each row, scores [B, K] finite and best first."""
    K = cfg.beam_size
    check(tokens.shape == (B, K, cfg.max_len + 1),
          f"beam tokens shape {tokens.shape}, expected"
          f" {(B, K, cfg.max_len + 1)}")
    check_tokens(tokens.reshape(B * K, -1), B * K, cfg, vocab)
    check(scores.shape == (B, K) and bool(np.isfinite(scores).all()),
          f"beam scores {scores.shape} not finite")
    check(bool((np.diff(scores, axis=1) <= 0).all()),
          "beam scores are not sorted best first")


def beam_launches_a_step(torch, rows: int, beam: int,
                         n_contexts: int = 2) -> dict:
    """Each decode kernel's launches in one flagship step of `rows`
    rows, from the kernels' plans: a band call a band, a conv and an FFN
    call a layer, an attention call a layer and context (`n_contexts`
    of them)."""
    from news_image_caption_tpu_torch.config import FLAGSHIP
    from news_image_caption_tpu_torch.ops import _build
    from news_image_caption_tpu_torch.ops.band_topk import band_plan
    from news_image_caption_tpu_torch.ops.decode_blocks import (
        conv_block_plan, ffn_plan)
    sms = _build.sms_of(torch.device("cuda"))
    D, H = FLAGSHIP["embed_dim"], FLAGSHIP["num_heads"]
    cut = FLAGSHIP["cutoff"]
    bands = [cut[0] + len(cut) - 1] + [b - a for a, b in zip(cut, cut[1:])]
    layers = FLAGSHIP["kernel_sizes"]
    return {
        "band_topk_lse": sum(band_plan(rows, D, v, beam, sms).launches
                             for v in bands),
        "decode_cross_attention": n_contexts * len(layers),
        "decode_conv_block": sum(conv_block_plan(rows, D, H, K, sms).launches
                                 for K in layers),
        "decode_ffn_block": len(layers) * ffn_plan(
            rows, D, FLAGSHIP["ffn_dim"], sms).launches}


def rescore_beams(torch, decoder, batch, tokens, scores, cfg):
    """Each returned beam's raw score (its score times len**alpha, len
    counting the tokens that are not pad) against the sum of its tokens'
    log-probs re-scored by teacher forcing (`decoder.log_prob`, the
    full-sequence path) up to and including its eos. Returns (|diff|,
    tokens summed) a beam."""
    from news_image_caption_tpu_torch.models.captioner import \
        TransformerFlattened
    B, K, L1 = tokens.shape
    flat = tokens.reshape(B * K, L1)
    ctx = {k: v.repeat_interleave(K, 0)
           for k, v in TransformerFlattened._contexts(batch).items()}
    with torch.inference_mode():
        lp = decoder.log_prob(flat[:, :-1], ctx)
    step_lp = torch.gather(lp, 2, flat[:, 1:, None])[..., 0].float()
    eos = (flat[:, 1:] == cfg.eos_id).int()
    live = (torch.cumsum(eos, 1) - eos) == 0       # no eos before the step
    rescored = (step_lp * live).sum(1)
    lengths = (flat != cfg.pad_id).sum(1).float()
    raw = scores.reshape(-1) * lengths.clamp(min=1) ** cfg.length_penalty
    return (raw - rescored).abs(), rescored, live.sum(1)


def check_rescored(torch, decoder, batch, tokens, scores, cfg,
                   what: str) -> None:
    """`rescore_beams` on the card, held to its bound: the bf16
    teacher-forced log-probs are rounded to bf16 up to three times
    (head, tail, prior add; 0.031 each at |lp| < 16), and the two paths'
    hidden states differ by bf16 roundings: 0.05 a token plus 1% of the
    sum."""
    diff, rescored, n_tok = rescore_beams(
        torch, decoder, batch, torch.from_numpy(tokens).cuda(),
        torch.from_numpy(scores).cuda(), cfg)
    bound = 0.05 * n_tok + 0.01 * rescored.abs()
    print(f"  {what}: score x len^alpha against the teacher-forced sum of"
          f" its log-probs: max |diff| {diff.max().item():.4g} over sums of"
          f" {rescored.min().item():.1f} to {rescored.max().item():.1f}"
          f" (bound 0.05 a token + 1%); largest share of the bound"
          f" {(diff / bound).max().item():.3f}", flush=True)
    check(bool((diff <= bound).all()),
          f"{what}: beam scores disagree with teacher forcing")


def beam_phase(torch, counted, predict):
    """Phase 4b. Beam-5 requests through `TransformerFlattened.
    generate_beam` with the serving phase's flagship model and weights,
    max_len 32 and early exit: five timed requests of 16 items and four
    of 128, then one profiled request of each, and at B=16 an early-exit
    and a harvest search on a copy of the model whose beams finish
    (`finishing_requests`). Checks
    the tokens and scores, that every kernel's launches equal its plan's
    count a step times the steps run, the scores against a
    teacher-forced re-scoring on the card, and the kernel path against
    the plain path on the CPU, at both sizes. Returns the beam path's
    launch count of each kernel and the timings (a smoke reading: the
    request latency metric is `--serving-latency`'s)."""
    from news_image_caption_tpu_torch.config import FLAGSHIP
    from news_image_caption_tpu_torch.generation.generator import \
        GenerationConfig
    from torch.profiler import ProfilerActivity, profile

    model, weights = predict.model, predict.weights
    K, vocab = 5, FLAGSHIP["vocab_size"]
    cfg = GenerationConfig(max_len=32, early_exit=True, beam_size=K)
    rng = np.random.RandomState(1)

    def beam_steps(tokens):
        return decode_steps(tokens.reshape(-1, tokens.shape[-1]),
                            cfg.eos_id, cfg.max_len)

    launches = {name: 0 for name in counted}
    summary = {}
    for B, n_req in ((16, 5), (128, 4)):
        jobs = [make_job(rng, B, rng.randint(20, 513, size=B))
                for _ in range(n_req)]
        batches = [stage_batch(torch, job, "cuda") for job in jobs]
        model.generate_beam(batches[0], cfg, weights)       # warm-up
        torch.cuda.synchronize()
        per_step = beam_launches_a_step(torch, B * K, K)
        for fn in counted.values():
            fn.launches = 0
        lat, steps, outs = [], 0, []
        for batch in batches:
            t = time.perf_counter()
            tokens, scores = model.generate_beam(batch, cfg, weights)
            tokens, scores = tokens.cpu().numpy(), scores.cpu().numpy()
            lat.append((time.perf_counter() - t) * 1e3)
            check_beams(tokens, scores, B, cfg, vocab)
            steps += beam_steps(tokens)
            outs.append((tokens, scores))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            tokens, _ = model.generate_beam(batches[0], cfg, weights)
            n = beam_steps(tokens.cpu().numpy())
            wall = (time.perf_counter() - t) * 1e3
        steps += n
        for name, fn in counted.items():
            print(f"  B={B} beam {K}: {name}: {fn.launches} launches over"
                  f" {steps} steps (plan: {per_step[name]} a step at"
                  f" {B * K} rows)")
            check(fn.launches == per_step[name] * steps and fn.launches > 0,
                  f"{name} launched {fn.launches} times at B={B} beam {K},"
                  f" expected {per_step[name] * steps}")
            launches[name] += fn.launches
        dev_events = [e for e in prof.key_averages()
                      if str(e.device_type).endswith("CUDA")]
        busy = sum(e.self_device_time_total for e in dev_events) / 1e3
        check(busy > 0, "the profiler saw no device time")
        lat_sorted = sorted(lat)
        p50 = lat_sorted[len(lat) // 2]
        summary[B] = {"requests": lat, "p50_ms": p50,
                      "captions_per_s": B * 1e3 / p50,
                      "steps_per_request": (steps - n) / len(lat),
                      "profiled_wall_ms": wall, "device_busy_ms": busy,
                      "device_busy_share": busy / wall,
                      "device_ms_per_step": busy / n}
        print(f"  B={B} beam {K}: request ms {[round(x, 1) for x in lat]},"
              f" p50 {p50:.1f} ms, {B * 1e3 / p50:.1f} captions/s;"
              f" profiled request: {n} steps, wall {wall:.1f} ms, device"
              f" busy {busy:.2f} ms ({100 * busy / wall:.1f}%),"
              f" {busy / n:.4f} device ms a step; best beam of item 0"
              f" {outs[0][0][0, 0, :10].tolist()}", flush=True)
        top = sorted(dev_events, key=lambda e: -e.self_device_time_total)
        for e in top[:6]:
            print(f"    {e.self_device_time_total / 1e3 / n:8.4f} ms/step"
                  f" x{e.count / n:<5.1f} {e.key[:80]}")
        check_rescored(torch, model.decoder, batches[0], *outs[0], cfg,
                       f"B={B} beam {K}")
        beam_vs_plain(torch, model, weights, jobs[0], cfg, search=B == 16)
        if B == 16:
            summary[B]["finishing_steps"], more = finishing_requests(
                torch, counted, model, batches[0], outs[0][0], cfg, per_step)
            for name, n in more.items():
                launches[name] += n
    summary["launches"] = launches
    return launches, summary


def finishing_requests(torch, counted, model, batch, tokens, cfg,
                       per_step) -> dict:
    """Two beam-5 requests at B=16 on a copy of the model whose eos word
    row leans toward the decoder's mean state m (as the tests' weights
    do, at flagship width), so that beams finish: eos rises by `lift`
    at that state, `lift` the mean gap between a step's best log-prob
    and eos's (teacher forced over `tokens`, a search's beams on the
    same batch) plus the first of 1, 2, 4, 8, 16 at which an early-exit
    search stops before max_len with beams ending at different steps.
    At that lift: the early-exit search, then one with harvest (the
    done list; early exit on, which a harvest search reaches only if
    all its live beams emit eos in one step). Checks for each the
    steps run, that every returned beam ends in eos and pad follows it,
    that beams end at different steps, the launches against the plans a
    step times the steps, and the scores against teacher forcing.
    Returns ({config: steps run}, {kernel: launches in the two checked
    searches})."""
    from news_image_caption_tpu_torch.models.captioner import \
        TransformerFlattened
    decoder = copy.deepcopy(model.decoder)
    B, K, L1 = tokens.shape
    flat = torch.from_numpy(tokens).cuda().reshape(B * K, L1)[:, :-1]
    ctx = {k: v.repeat_interleave(K, 0)
           for k, v in TransformerFlattened._contexts(batch).items()}
    with torch.inference_mode():
        m = decoder.hidden(flat, ctx).float().mean((0, 1))
        lp = decoder.log_prob(flat, ctx).float()
        gap = (lp.max(-1).values - lp[..., cfg.eos_id]).mean().item()
    del lp
    e0 = decoder.embedder.adaptive.embed_0
    row = e0[cfg.eos_id].detach().float().clone()
    steps = []
    step_topk = decoder.step_topk

    def counted_step(tok, i, *args, **kw):
        steps.append(i)
        return step_topk(tok, i, *args, **kw)
    decoder.step_topk = counted_step
    biased = TransformerFlattened(decoder=decoder)

    def search(c):
        steps.clear()
        tok, sc = biased.generate_beam(batch, c, weights)
        tok, sc = tok.cpu().numpy(), sc.cpu().numpy()
        ends = [int(np.argmax(r[1:] == cfg.eos_id)) + 1
                if (r[1:] == cfg.eos_id).any() else 0
                for r in tok.reshape(B * K, L1)]
        return tok, sc, len(steps), ends

    for extra in (1.0, 2.0, 4.0, 8.0, 16.0):
        lift = gap + extra
        with torch.no_grad():
            e0[cfg.eos_id] = (row + lift * m / (m @ m)).to(e0.dtype)
        weights = decoder.decode_weights()
        _, _, n, ends = search(cfg)
        print(f"  B={B} beam {K}, eos raised by {lift:.2f}: {n} steps,"
              f" beams end at steps {sorted(set(ends))}", flush=True)
        if n < cfg.max_len and min(ends) > 0 and len(set(ends)) > 1:
            break
    run, launches = {}, {key: 0 for key in counted}
    for name, c in (("early_exit", cfg),
                    ("harvest", dataclasses.replace(cfg,
                                                    harvest_finished=True))):
        for fn in counted.values():
            fn.launches = 0
        tok, sc, n, ends = search(c)
        run[name] = n
        print(f"  B={B} beam {K} {name}, eos raised by {lift:.2f}: {n}"
              f" steps, the returned beams end at steps {min(ends)} to"
              f" {max(ends)}; launches"
              f" {dict((k, f.launches) for k, f in counted.items())}",
              flush=True)
        check_beams(tok, sc, B, c, model.decoder.vocab_size)
        check(name == "harvest" or n < cfg.max_len,
              "early exit did not stop the search")
        check(min(ends) > 0, f"{name}: a returned beam has no eos")
        check(len(set(ends)) > 1, f"{name}: every returned beam ended at"
              " one step")
        for key, fn in counted.items():
            check(fn.launches == per_step[key] * n,
                  f"{key} launched {fn.launches} times in the {name}"
                  f" search, expected {per_step[key] * n}")
            launches[key] += fn.launches
        check_rescored(torch, decoder, batch, tok, sc, c,
                       f"B={B} beam {K} {name}")
    return run, launches


def beam_vs_plain(torch, model, weights, job, cfg, search: bool):
    """The kernel path against the plain path on the CPU (the same
    weights) on one beam-5 request: step 0's candidates (every beam of
    an item starts from bos) within 0.1 and their ids; then, with
    `search`, the first tokens of the beams of 8-step searches, as
    multisets an item."""
    from news_image_caption_tpu_torch.models.captioner import \
        TransformerFlattened
    K = cfg.beam_size
    B = job["image"].shape[0]
    batches = {dev: stage_batch(torch, job, dev) for dev in ("cuda", "cpu")}
    cpu_model = TransformerFlattened(
        decoder=copy.deepcopy(model.decoder).to("cpu"))
    short = dataclasses.replace(cfg, max_len=8)
    t = time.perf_counter()
    out = {}
    for dev, m, w in (("cuda", model, weights), ("cpu", cpu_model, None)):
        with torch.inference_mode():
            kvs, caches, seed, w = m._decode_setup(batches[dev], cfg, w, K)
            cand = m.decoder.step_topk(seed.repeat_interleave(K), 0, kvs,
                                       caches, K, w, beam=K)
            out[dev] = [c.cpu() for c in cand]
            if search:
                out[dev].append(m.generate_beam(batches[dev], short,
                                                w)[0].cpu())
    print(f"  plain path on the CPU: {time.perf_counter() - t:.1f} s")
    (v_k, i_k, *t_k), (v_p, i_p, *t_p) = out["cuda"], out["cpu"]
    e0 = (v_k - v_p).abs().max().item()
    agree_ids = (i_k == i_p).float().mean().item()
    line = (f"  B={B} beam {K} step 0, kernel vs plain path: candidate"
            f" log-probs max |diff| {e0:.4g} (tol 0.1), candidate ids equal"
            f" {agree_ids:.3f} (min 0.75)")
    if search:
        first = []
        for a, b in zip(t_k[0][:, :, 1].tolist(), t_p[0][:, :, 1].tolist()):
            first.append(sum(min(a.count(x), b.count(x)) for x in set(a)) / K)
        agree = float(np.mean(first))
        same = (t_k[0] == t_p[0]).float().mean().item()
        line += (f"; first tokens of the beams after 8 steps agree"
                 f" {agree:.3f} (min 0.75); all tokens equal {same:.3f}")
    print(line, flush=True)
    check(e0 <= 0.1, f"B={B} beam step-0 candidates of the kernel and plain"
          " paths differ")
    check(agree_ids >= 0.75, f"B={B} beam step-0 candidate ids of the kernel"
          " and plain paths differ")
    if search:
        check(agree >= 0.75, "beam first tokens of the kernel and plain paths"
              " differ")


def train_phase(torch, flash):
    """Phase 5. Returns the main-path launch count of each flash kernel
    over the 20 train steps."""
    from news_image_caption_tpu_torch.config import (FLAGSHIP,
                                                     FLAGSHIP_ARTICLE_LEN,
                                                     FLAGSHIP_BATCH_SIZE,
                                                     FLAGSHIP_CAPTION_LEN,
                                                     FLAGSHIP_IMAGE_LEN)
    from news_image_caption_tpu_torch.data.synthetic import (
        SyntheticNewsDataset, to_device)
    from news_image_caption_tpu_torch.models.captioner import \
        TransformerFlattened
    from news_image_caption_tpu_torch.training.builder import \
        flagship_trainer_builder
    from news_image_caption_tpu_torch.training.train_step import \
        make_eval_step

    B, steps = FLAGSHIP_BATCH_SIZE, 20
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model, state, train_step, eval_step = flagship_trainer_builder(
        "cuda", seed=0, t_total=100)
    n_params = sum(p.numel() for p in state.params.values())
    ds = SyntheticNewsDataset(
        size=B, vocab_size=FLAGSHIP["vocab_size"],
        caption_len=FLAGSHIP_CAPTION_LEN, article_len=FLAGSHIP_ARTICLE_LEN,
        n_patches=FLAGSHIP_IMAGE_LEN, image_dim=FLAGSHIP["image_dim"],
        article_dim=FLAGSHIP["article_dim"], seed=0)
    batch_np = next(ds.batches(B, shuffle=False))
    batch = to_device(batch_np, "cuda")
    torch.cuda.synchronize()
    print(f"  trainer built in {time.perf_counter() - t0:.1f} s: {n_params}"
          f" parameters, bf16 stored, fp32 master; batch {B}, caption"
          f" {FLAGSHIP_CAPTION_LEN} (T = {FLAGSHIP_CAPTION_LEN - 1}),"
          f" article {FLAGSHIP_ARTICLE_LEN}, image {FLAGSHIP_IMAGE_LEN}",
          flush=True)

    counted = {"flash_attention_fwd": flash.flash_attention_fwd,
               "flash_attention_bwd": flash.flash_attention_bwd}
    for fn in counted.values():
        fn.launches = 0
    losses, skipped, wall = [], [], []
    for _ in range(steps):
        t = time.perf_counter()
        state, m = train_step(state, batch, 0)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t)
        losses.append(m["loss"].item())
        skipped.append(m["skipped"])
    launches = {name: fn.launches for name, fn in counted.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print("  losses (bits/token): " + " ".join(f"{x:.4f}" for x in losses))
    ms = sorted(wall[1:])[len(wall[1:]) // 2] * 1e3
    print(f"  step time (host clock, synchronised), median of steps 2-{steps}:"
          f" {ms:.2f} ms, {B / ms * 1e3:.1f} samples/s (first step"
          f" {wall[0] * 1e3:.1f} ms); peak device memory {peak:.2f} GiB",
          flush=True)
    check(all(np.isfinite(losses)), "a train loss is not finite")
    check(losses[-1] < losses[0],
          f"the loss did not fall: {losses[0]:.4f} -> {losses[-1]:.4f}")
    check(sum(skipped) == 0, f"{sum(skipped)} steps were skipped")
    per_step = 2 * FLAGSHIP["num_layers"]
    for name, n in launches.items():
        print(f"  {name}: {n} launches over {steps} steps (expected"
              f" {per_step} per step)")
        check(n == per_step * steps,
              f"{name} launched {n} times, expected {per_step * steps}")

    # Where the device time of a step goes (3 profiled steps).
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(3):
            state, _ = train_step(state, batch, 0)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t) * 1e3
    # Device operations only: the train step's record_function spans
    # also appear as device-side annotation rows, which would count twice.
    dev_events = [e for e in prof.key_averages()
                  if str(e.device_type).endswith("CUDA")
                  and not e.key.startswith("train_step.")]
    busy = sum(e.self_device_time_total for e in dev_events) / 1e3
    by_name = sorted(dev_events, key=lambda e: -e.self_device_time_total)
    fwd = sum(e.self_device_time_total for e in dev_events
              if "flash_fwd_kernel" in e.key) / 1e3
    bwd = sum(e.self_device_time_total for e in dev_events
              if "flash_bwd_kernel" in e.key) / 1e3
    check(busy > 0, "the profiler saw no device time")
    print(f"  profiled 3 steps: wall {prof_wall:.1f} ms, device busy"
          f" {busy:.1f} ms ({100 * busy / prof_wall:.1f}%), flash forward"
          f" {fwd:.2f} ms ({100 * fwd / busy:.1f}% of busy), flash backward"
          f" {bwd:.2f} ms ({100 * bwd / busy:.1f}%)")
    for e in by_name[:8]:
        print(f"    {e.self_device_time_total / 3e3:8.3f} ms/step"
              f" x{e.count // 3:<4d} {e.key[:90]}")

    # Kernel path vs plain path: the deterministic loss of the trained
    # weights on 4 rows, on the card and on the CPU (plain versions).
    rows = {k: v[:4] for k, v in batch_np.items()}
    got = eval_step(to_device(rows, "cuda"))["loss"].item()
    cpu_model = TransformerFlattened(
        decoder=copy.deepcopy(model.decoder).to("cpu"))
    t = time.perf_counter()
    want = make_eval_step(cpu_model.loss_fn)(to_device(rows, "cpu"))["loss"]
    want = want.item()
    print(f"  deterministic loss on 4 rows: kernel path {got:.5f}, plain path"
          f" on the CPU {want:.5f} bits/token ({time.perf_counter() - t:.1f} s);"
          f" |diff| {abs(got - want):.4g} (tol 0.01 |plain|)", flush=True)
    check(abs(got - want) <= 0.01 * abs(want),
          "the kernel and plain paths' losses differ")
    return launches, ms


def dynamic_conv_bytes(B: int, T: int, C: int, H: int, K: int) -> int:
    """Bytes the dynamic conv must move in bf16: x and w read once, the
    output written once."""
    return 2 * (2 * B * T * C + B * T * H * K)


def dynamic_conv_phase(torch, dc):
    """Phase 6. Returns ({"dynamic_conv": dict(max_abs_err, ms,
    plain_ms, bound_ms, bound_by, library_ms)}, the main-path launch
    count), the times summed over the four layer widths: one forward of
    each flagship layer's conv. The faster of the module's shift and
    band routes a width, each the port's own plain PyTorch, is the
    library yardstick: no single PyTorch call computes the function."""
    from news_image_caption_tpu_torch.ops import conv
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    bf16 = torch.bfloat16
    B, T, C, H = 16, 512, 1024, 16
    widths = (3, 7, 15, 31)
    x = torch.randn(B, T, C, generator=gen, device=dev).to(bf16)
    xh = x.view(B, T, H, C // H)
    tally = Tally("fp32")
    for K in widths:
        w = torch.softmax(torch.randn(B, T, H, K, generator=gen, device=dev),
                          -1).to(bf16)
        got = dc.dynamic_conv(x, w, H)
        again = dc.dynamic_conv(x, w, H)
        want = dc.dynamic_conv_plain(x, w, H)
        torch.cuda.synchronize()
        d = (got.float() - want.float()).abs()
        e = d.max().item()
        ok = bool((d <= dc.dynamic_conv_tolerance(x, w, H)).all())
        exact = bool(torch.equal(got, want))
        t_k = time_ms(lambda: dc.dynamic_conv(x, w, H))
        t_p = time_ms(lambda: dc.dynamic_conv_plain(x, w, H))
        t_s = time_ms(lambda: conv._shift_accumulate(xh, w, K))
        t_b = time_ms(lambda: conv._band_matmul(xh, w, K))
        floor_us = dynamic_conv_bytes(B, T, C, H, K) / HBM_BYTES_PER_S * 1e6
        print(f"  dynamic_conv B={B} T={T} C={C} H={H} K={K}: max |diff| {e:.3g}"
              f" (tol: fused sums' bound + one bf16 unit), bit-equal {exact};"
              f" kernel {t_k * 1e3:.2f} us ({floor_us:.2f} us floor at 3.35"
              f" TB/s, {100 * floor_us / (t_k * 1e3):.1f}% of it), plain"
              f" {t_p:.4f} ms, shift route {t_s:.4f} ms, band route"
              f" {t_b:.4f} ms", flush=True)
        # A product of two bf16 values is exact in fp32: the fused sums
        # are the plain version's, bit for bit.
        check(ok and exact,
              f"dynamic_conv K={K} disagrees with its plain version")
        check(bool(torch.equal(got, again)),
              f"dynamic_conv K={K}: two calls differ")
        tally.errs.append(e)
        # x and w read, the output written; one fp32 multiply and add a
        # tap and channel, outside the tensor cores.
        tally.add((x, w, got), 2.0 * B * T * C * K, t_k, t_p,
                  library_ms=min(t_s, t_b))

    # The module: one launch per forward at T % 128 == 0, none otherwise.
    dc.dynamic_conv.launches = 0
    x63 = x[:, :63].contiguous()
    for K in widths:
        mod = conv.DynamicConv(
            C, K, H, device=dev, dtype=bf16, method="pallas",
            generator=torch.Generator(device=dev).manual_seed(K))
        before = dc.dynamic_conv.launches
        out = mod(x)        # under grad mode: the backward is checked below
        check(dc.dynamic_conv.launches == before + 1,
              f"DynamicConv(K={K}) at T={T} launched"
              f" {dc.dynamic_conv.launches - before} kernels, expected 1")
        check(tuple(out.shape) == (B, T, C) and out.dtype == bf16
              and bool(torch.isfinite(out).all()),
              f"DynamicConv(K={K}) output {tuple(out.shape)} {out.dtype}")
        cpu = copy.deepcopy(mod).to("cpu")
        with torch.no_grad():
            want = cpu(x.cpu())
        # The taps come from a bf16 matmul on each device: one bf16
        # rounding of a logit (2^-7 at |logit| < 2) moves a tap by under
        # 1%, and the sum by under 1% of max |x| (about 5).
        e, ok = within(out.detach().cpu(), want, 0.05, 0.02)
        print(f"  DynamicConv(1024, {K}, 16, method='pallas') T={T}: one"
              f" launch; vs the same module on the CPU {e:.3g}"
              f" (tol 0.05 + 0.02|ref|)", flush=True)
        check(ok, f"DynamicConv(K={K}) on the card and on the CPU differ")
        raised = False
        try:
            out.float().sum().backward()
        except NotImplementedError:
            raised = True
        check(raised, f"DynamicConv(K={K}): backward through the kernel"
              " did not raise")
        before = dc.dynamic_conv.launches
        shift = copy.deepcopy(mod)
        shift.method = "shift"
        with torch.no_grad():
            same = bool(torch.equal(mod(x63), shift(x63)))
        check(dc.dynamic_conv.launches == before,
              f"DynamicConv(K={K}) at T=63 launched the kernel")
        check(same, f"DynamicConv(K={K}) at T=63 is not the shift route")
    launches = dc.dynamic_conv.launches
    print(f"  DynamicConv at T=63: no launch, equal to the shift route;"
          f" backward raises; {launches} launches over {len(widths)}"
          f" forwards at T={T} (expected {len(widths)})", flush=True)
    check(launches == len(widths), f"dynamic_conv launched {launches} times")
    return {"dynamic_conv": tally.result()}, launches


EVAL_CONFIG = "configs/goodnews_transformer_roberta.yaml"


def check_evaluate_files(out_dir: str, attn_dir: str, n_batches: int,
                         cfg, n_records: int = 256, suffix: str = "",
                         contexts=("image", "article"),
                         empty_ok: bool = False) -> list:
    """Phase 7's (and 8's and 10's) checks of the files the command
    wrote; the attention dumps hold a map a layer and attended context.
    With `empty_ok` (a trained model may end a caption at once), a record
    may have an empty generation where its dumped tokens hold nothing but
    bos, eos and pad, and nowhere else. Returns each batch's tokens, read
    back from its attention dump."""
    import math

    from news_image_caption_tpu_torch.config import FLAGSHIP
    from news_image_caption_tpu_torch.evaluation import checkdiff
    from news_image_caption_tpu_torch.evaluation.compute_metrics import \
        compute_metrics
    gen_path = f"{out_dir}/generations{suffix}.jsonl"
    with open(gen_path) as f:
        recs = [json.loads(line) for line in f]
    check(len(recs) == n_records,
          f"{len(recs)} generations, expected {n_records}")
    check(all(k in r for r in recs for k in checkdiff.ENRICHED_FIELDS),
          "a generation record lacks its enrichment")
    with open(f"{out_dir}/evaluate-metrics{suffix}.json") as f:
        metrics = json.load(f)
    keys = ("bleu-1", "bleu-2", "bleu-3", "bleu-4", "cider", "rouge-l")
    check(metrics["n_samples"] == n_records
          and all(math.isfinite(metrics[k]) for k in keys),
          f"evaluate metrics {metrics}")
    offline = compute_metrics(gen_path)
    for k in ("BLEU-1", "BLEU-4", "ROUGE", "CIDEr", "All names - recall",
              "Entity all - precision", "Generation TTR"):
        check(k in offline, f"compute_metrics lacks {k!r}")
    tokens, worst = [], 0.0
    want = {f"layer{li}_{c}" for li in range(FLAGSHIP["num_layers"])
            for c in contexts}
    for i in range(n_batches):
        with np.load(f"{attn_dir}/attn_{i:05d}.npz") as z:
            tok = z["tokens"]
            check(tok.shape == (16, cfg.max_len + 1),
                  f"dumped tokens of shape {tok.shape}")
            maps = [k for k in z.files if k != "tokens"]
            check(set(maps) == want, f"dumped maps {sorted(z.files)}")
            for k in maps:
                arr = z[k]
                check(arr.shape[:2] == tok.shape, f"{k} of shape {arr.shape}")
                worst = max(worst, float(np.abs(arr.sum(-1) - 1.0).max()))
            tokens.append(tok)
    # A generation is empty where every token is bos 0, pad 1 or eos 2.
    empty = [bool(np.isin(row, (0, 1, 2)).all())
             for tok in tokens for row in tok]
    expected = ({"missing_generation": sum(empty)} if empty_ok and any(empty)
                else {})
    integrity = checkdiff.integrity_check(gen_path)
    check(integrity["records"] == n_records
          and integrity["problems"] == expected
          and [not r["generation"] for r in recs] == empty,
          f"integrity check failed: {integrity} (expected problems"
          f" {expected})")
    print(f"  files: {n_records} enriched records, integrity as expected"
          f" ({sum(empty)} empty generations, each a caption of bos, eos and"
          f" pad only), metrics { {k: round(metrics[k], 4) for k in keys} },"
          f" compute_metrics {len(offline)} keys; {n_batches} attention"
          f" dumps, rows sum to 1 within {worst:.3g} (tol 1e-2)", flush=True)
    check(worst <= 1e-2, "a dumped attention row does not sum to 1")
    return tokens


def evaluate_phase(torch, counted):
    """Phase 7. The evaluate command on the flagship config's test split,
    then its first batch again with the command's model rebuilt: against
    the dumped tokens, profiled, and against the plain path on the CPU.
    Returns the command's launch count of each decode kernel and a
    summary."""
    import tempfile

    from news_image_caption_tpu_torch import cli
    from news_image_caption_tpu_torch.config import (build_dataset,
                                                     load_config)
    from news_image_caption_tpu_torch.models.captioner import \
        TransformerFlattened
    from torch.profiler import ProfilerActivity, profile

    per_step = greedy_launches_a_step()
    with tempfile.TemporaryDirectory() as tmp:
        out_dir, attn_dir = f"{tmp}/serialization", f"{tmp}/attn"
        overrides = json.dumps({"trainer": {"serialization_dir": out_dir}})
        cfg = load_config(EVAL_CONFIG, overrides)
        gcfg = cli.generation_config(cfg)
        timings = {}
        for fn in counted.values():
            fn.launches = 0
        t = time.perf_counter()
        rc = cli.main(["evaluate", EVAL_CONFIG, "--split", "test",
                       "--dump-attention", attn_dir, "-o", overrides],
                      timings=timings)
        wall = time.perf_counter() - t
        launches = {name: fn.launches for name, fn in counted.items()}
        check(rc == 0, f"evaluate returned {rc}")
        n_batches = 256 // cfg["iterator"]["batch_size"]
        tokens = check_evaluate_files(out_dir, attn_dir, n_batches, gcfg)
    steps = sum(decode_steps(t, gcfg.eos_id, gcfg.max_len) for t in tokens)
    print(f"  command: {wall:.1f} s, {256 / wall:.2f} captions/s; spans"
          f" (host clock, s) { {k: round(v, 3) for k, v in timings.items()} }",
          flush=True)
    for name, n in launches.items():
        print(f"  {name}: {n} launches over {steps} steps"
              f" (expected {per_step[name]} per step)")
        check(n == per_step[name] * steps and n > 0,
              f"{name} launched {n} times, expected {per_step[name] * steps}")

    model = cli.evaluation_model(cfg, torch.device("cuda"))
    weights = model.decoder.decode_weights()
    batch_np = next(build_dataset(cfg, "test").batches(16, shuffle=False))
    batch = {k: torch.from_numpy(batch_np[k]).cuda()
             for k in ("image", "image_mask", "article", "article_mask")}
    tok_k, lp_k = model.generate(batch, gcfg, weights)
    check(bool(np.array_equal(tok_k.to(torch.int32).cpu().numpy(),
                              tokens[0])),
          "the rebuilt model's first batch differs from the command's")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        prof_tokens, _ = model.generate(batch, gcfg, weights)
        n = decode_steps(prof_tokens.cpu().numpy(), gcfg.eos_id, gcfg.max_len)
        batch_wall = (time.perf_counter() - t) * 1e3
    dev_events = [e for e in prof.key_averages()
                  if str(e.device_type).endswith("CUDA")]
    busy = sum(e.self_device_time_total for e in dev_events) / 1e3
    check(busy > 0, "the profiler saw no device time")
    print(f"  profiled batch: {n} steps, wall {batch_wall:.1f} ms, device"
          f" busy {busy:.2f} ms ({100 * busy / batch_wall:.1f}%),"
          f" {busy / n:.4f} device ms a step", flush=True)

    cpu_model = TransformerFlattened(
        decoder=copy.deepcopy(model.decoder).to("cpu"))
    short = dataclasses.replace(gcfg, max_len=min(16, gcfg.max_len))
    t = time.perf_counter()
    tok_p, lp_p = cpu_model.generate({k: v.cpu() for k, v in batch.items()},
                                     short)
    print(f"  plain path on the CPU, {short.max_len} steps:"
          f" {time.perf_counter() - t:.1f} s")
    lp_k, tok_k = lp_k.cpu(), tok_k.cpu()
    check(bool(torch.isfinite(lp_k).all()), "non-finite log-probs")
    e0 = (lp_k[:, 0] - lp_p[:, 0]).abs().max().item()
    agree0 = (tok_k[:, 1] == tok_p[:, 1]).float().mean().item()
    agree = (tok_k[:, 1:short.max_len + 1]
             == tok_p[:, 1:]).float().mean().item()
    print(f"  first batch, step-0 top-1 log-prob, kernel vs plain path: max"
          f" |diff| {e0:.4g} (tol 0.1); step-0 token agreement {agree0:.3f}"
          f" (min 0.75); token agreement over {short.max_len} steps"
          f" {agree:.3f}", flush=True)
    check(e0 <= 0.1, "step-0 log-probs of the kernel and plain paths differ")
    check(agree0 >= 0.75, "step-0 tokens of the kernel and plain paths differ")
    return launches, {
        "config": EVAL_CONFIG, "samples": 256, "batch_size": 16,
        "max_len": gcfg.max_len, "decode_steps": steps, "wall_s": wall,
        "captions_per_s": 256 / wall, "spans_s": timings,
        "profiled_batch": {"steps": n, "wall_ms": batch_wall,
                           "device_busy_ms": busy,
                           "device_busy_share": busy / batch_wall,
                           "device_ms_per_step": busy / n},
        "step0_lp_diff": e0, "step0_token_agreement": agree0,
        "card": card_line(), "launches": launches}


def train_command_overrides(out_dir: str) -> dict:
    """Phase 8's cuts of the flagship YAML: amounts only (records,
    epochs, checkpoints kept, the log interval, the schedule's length),
    no width or depth."""
    return {"dataset": {"train": {"size": 64}, "val": {"size": 32},
                        "test": {"size": 32}},
            "trainer": {"num_epochs": 2, "num_serialized_models_to_keep": 2,
                        "log_every": 2, "optimizer": {"t_total": 100},
                        "serialization_dir": out_dir}}


def fp64_mean(torch, trees, dtype):
    """The store's `avg`: fp64 sum over the trees, divided, cast back."""
    out = {}
    for k in trees[0]:
        acc = torch.zeros(trees[0][k].shape, dtype=torch.float64)
        for t in trees:
            acc += t[k].to(torch.float64)
        out[k] = (acc / len(trees)).to(dtype)
    return out


def train_command_phase(torch, flash, counted):
    """Phase 8. The train command on the flagship YAML (bf16_o2, flash,
    the YAML's dropouts, B=16) with phase 8's cuts, then `evaluate -m
    best` and `-m avg:2` from its checkpoints. Returns each kernel's
    launches on the two paths, a summary, and what phase 24 compares
    with: the logged records and `-m best`'s generations file."""
    import tempfile

    from news_image_caption_tpu_torch import cli
    from news_image_caption_tpu_torch.config import (FLAGSHIP,
                                                     build_dataset,
                                                     load_config)
    from news_image_caption_tpu_torch.data.synthetic import LOSS_KEYS
    from news_image_caption_tpu_torch.models.captioner import \
        TransformerFlattened
    from news_image_caption_tpu_torch.training.train_step import \
        make_eval_step

    flash_counted = {"flash_attention_fwd": flash.flash_attention_fwd,
                     "flash_attention_bwd": flash.flash_attention_bwd}
    all_counted = {**flash_counted, **counted}
    per_step = greedy_launches_a_step()
    n_layers = FLAGSHIP["num_layers"]
    # A fresh temporary directory, removed with everything in it; the
    # command's checkpoints hold about 6.6 GB.
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = f"{tmp}/serialization"
        overrides = train_command_overrides(out_dir)
        print(f"  cuts of {EVAL_CONFIG}: {json.dumps(overrides)}", flush=True)
        ovr = json.dumps(overrides)
        cfg = load_config(EVAL_CONFIG, ovr)
        B = cfg["iterator"]["batch_size"]
        n_train = cfg["dataset"]["train"]["size"]
        n_val = cfg["dataset"]["val"]["size"]
        n_test = cfg["dataset"]["test"]["size"]
        epochs = cfg["trainer"]["num_epochs"]
        steps = epochs * (n_train // B)
        val_batches = epochs * (n_val // B)

        # The train command, every kernel's count set to 0 just before.
        timings = {}
        for fn in all_counted.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        rc = cli.main(["train", EVAL_CONFIG, "-o", ovr], timings=timings)
        wall = time.perf_counter() - t
        train_launches = {n: fn.launches for n, fn in all_counted.items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check(rc == 0, f"train returned {rc}")
        want = {"flash_attention_fwd": 2 * n_layers * (steps + val_batches),
                "flash_attention_bwd": 2 * n_layers * steps,
                **{n: 0 for n in counted}}
        how = {"flash_attention_fwd": f"{2 * n_layers} a train step x"
                                      f" {steps} + {2 * n_layers} a val"
                                      f" batch x {val_batches}",
               "flash_attention_bwd": f"{2 * n_layers} a train step x"
                                      f" {steps}"}
        for name, n in train_launches.items():
            print(f"  train: {name} {n} launches (expected {want[name]}"
                  + (f": {how[name]})" if name in how else ")"))
            check(n == want[name], f"{name} launched {n} times in train,"
                  f" expected {want[name]}")
        with open(f"{out_dir}/metrics.jsonl") as f:
            recs = [json.loads(line) for line in f]
        train_recs = [r for r in recs if r["split"] == "train"]
        val_recs = [r for r in recs if r["split"] == "val"]
        print("  metrics.jsonl: " + "; ".join(
            f"{r['split']} step {r['step']} loss {r['loss']:.4f}"
            + (f" input_wait {r['input_wait']}" if "input_wait" in r else "")
            for r in recs), flush=True)
        check(len(train_recs) == steps // cfg["trainer"]["log_every"]
              and len(val_recs) == epochs, f"records {recs}")
        check(all(np.isfinite(r["loss"]) for r in recs),
              "a logged loss is not finite")
        check(all(r["skipped"] == 0 for r in train_recs),
              "a train step was skipped")
        check(val_recs[1]["loss"] < val_recs[0]["loss"],
              f"val loss did not fall: {val_recs[0]['loss']:.4f} ->"
              f" {val_recs[1]['loss']:.4f}")
        ckpt_dir = f"{out_dir}/checkpoints"
        with open(f"{ckpt_dir}/meta.json") as f:
            meta = json.load(f)
        per_epoch = n_train // B
        check([c["step"] for c in meta["checkpoints"]]
              == [per_epoch, 2 * per_epoch], f"meta.json {meta}")
        best_step = min(meta["checkpoints"],
                        key=lambda c: c["metrics"]["loss"])["step"]
        check(meta["best"]["step"] == best_step, f"best of {meta}")

        step_s = sorted(timings["step_s"])
        step_ms = step_s[len(step_s) // 2] * 1e3
        epoch_s = [end - start for start, end in timings["epochs"]]
        saves = timings["checkpoints"]
        # The first checkpoint's write against the next epoch (host clock).
        first = saves[0]
        e1_start, e1_end = timings["epochs"][1]
        w_start = first["write_end"] - first["write_s"]
        overlap = max(0.0, min(first["write_end"], e1_end)
                      - max(w_start, e1_start))
        input_wait = [r["input_wait"] for r in train_recs]
        epochs_txt = [round(e, 2) for e in epoch_s]
        saves_txt = [(round(c["snapshot_s"], 3), round(c["write_s"], 3))
                     for c in saves]
        print(f"  train command: {wall:.1f} s; epochs {epochs_txt} s; train"
              f" step median {step_ms:.2f} ms ({B / step_ms * 1e3:.1f}"
              f" samples/s; host clock, the step's guard reads the device);"
              f" input_wait {input_wait}; saves (snapshot s, write s)"
              f" {saves_txt}; the step-{first['step']} write overlaps epoch 1"
              f" by {overlap:.2f} s; peak device memory {peak:.2f} GiB",
              flush=True)

        # evaluate -m best and -m avg:2, the decoded model captured.
        gcfg = cli.generation_config(cfg)
        captured = []
        real = cli.checkpoint_model

        def capture(*args, **kw):
            model = real(*args, **kw)
            captured.append(model)
            return model

        cli.checkpoint_model = capture
        eval_launches = dict.fromkeys(all_counted, 0)
        evals = {}
        try:
            for which, suffix in (("best", "_best"), ("avg:2", "_avg2")):
                attn_dir = f"{tmp}/attn{suffix}"
                for fn in all_counted.values():
                    fn.launches = 0
                t = time.perf_counter()
                rc = cli.main(["evaluate", EVAL_CONFIG, "-o", ovr, "-m",
                               which, "-s", suffix, "--dump-attention",
                               attn_dir])
                e_wall = time.perf_counter() - t
                got = {n: fn.launches for n, fn in all_counted.items()}
                check(rc == 0, f"evaluate -m {which} returned {rc}")
                tokens = check_evaluate_files(out_dir, attn_dir, n_test // B,
                                              gcfg, n_test, suffix)
                n_steps = [decode_steps(tk, gcfg.eos_id, gcfg.max_len)
                           for tk in tokens]
                lengths = []
                for tk in tokens:
                    for row in tk:
                        hits = np.flatnonzero(row[1:] == gcfg.eos_id)
                        lengths.append(int(hits[0]) + 1 if hits.size
                                       else gcfg.max_len)
                total = sum(n_steps)
                for name, n in got.items():
                    want = per_step.get(name, 0) * total
                    check(n == want, f"evaluate -m {which}: {name} launched"
                          f" {n} times, expected {want}")
                    eval_launches[name] += n
                if which == "best":
                    with open(f"{out_dir}/generations{suffix}.jsonl",
                              "rb") as f:
                        best_generations = f.read()
                evals[which] = {"wall_s": e_wall,
                                "captions_per_s": n_test / e_wall,
                                "steps_per_batch": n_steps,
                                "mean_steps_per_caption":
                                    float(np.mean(lengths)),
                                "captions_ending_in_eos": sum(
                                    n < gcfg.max_len for n in lengths),
                                "launches": got}
                print(f"  evaluate -m {which}: {e_wall:.1f} s,"
                      f" {n_test / e_wall:.2f} captions/s, steps a batch"
                      f" {n_steps}, mean steps a caption"
                      f" {np.mean(lengths):.2f}, launches {got}", flush=True)
        finally:
            cli.checkpoint_model = real
        check(len(captured) == 2, "evaluate did not load a checkpoint")

        # The decoded models hold the checkpoints' params cast to bf16.
        best = torch.load(f"{ckpt_dir}/best.pt", weights_only=True)["params"]
        pair = [torch.load(f"{ckpt_dir}/ckpt_{c['step']}.pt",
                           weights_only=True)["params"]
                for c in meta["checkpoints"]]
        for name, want_params in (
                ("best", best),
                ("avg:2", fp64_mean(torch, pair, pair[0][next(iter(pair[0]))]
                                    .dtype))):
            model = captured[0 if name == "best" else 1]
            sd = model.decoder.state_dict()
            check(set(sd) == set(want_params), f"{name}: parameter names")
            bad = [k for k, v in sd.items()
                   if v.dtype != torch.bfloat16
                   or not torch.equal(v.cpu(), want_params[k].bfloat16())]
            check(not bad, f"evaluate -m {name}: the decoded model differs"
                  f" from the checkpoint in {bad[:3]}")
        print(f"  evaluate -m best decodes best.pt's params (step"
              f" {meta['best']['step']}), -m avg:2 the fp64 mean of steps"
              f" {[c['step'] for c in meta['checkpoints']]}, tensor for"
              f" tensor in bf16", flush=True)

        # Kernel path vs plain path: the best checkpoint's deterministic
        # loss on 4 val rows, on the card and on the CPU.
        model = captured[0]
        rows_np = next(build_dataset(cfg, "val").batches(4, shuffle=False))
        rows = {k: torch.from_numpy(rows_np[k]) for k in LOSS_KEYS}
        got_loss = make_eval_step(model.loss_fn)(
            {k: v.cuda() for k, v in rows.items()})["loss"].item()
        cpu_model = TransformerFlattened(
            decoder=copy.deepcopy(model.decoder).to("cpu"))
        want_loss = make_eval_step(cpu_model.loss_fn)(rows)["loss"].item()
        print(f"  best checkpoint's deterministic loss on 4 rows: kernel path"
              f" {got_loss:.5f}, plain path on the CPU {want_loss:.5f}"
              f" bits/token; |diff| {abs(got_loss - want_loss):.4g}"
              f" (tol 0.01 |plain|)", flush=True)
        check(abs(got_loss - want_loss) <= 0.01 * abs(want_loss),
              "the best checkpoint's kernel and plain losses differ")
    summary = {
        "config": EVAL_CONFIG, "cuts": overrides["dataset"] | {
            k: v for k, v in overrides["trainer"].items()
            if k != "serialization_dir"},
        "batch_size": B, "train_steps": steps, "val_batches": val_batches,
        "wall_s": wall, "epoch_s": epoch_s, "step_ms_median": step_ms,
        "samples_per_s": B / step_ms * 1e3, "step_s": timings["step_s"],
        "input_wait": input_wait,
        "checkpoint_saves": [{"step": c["step"], "snapshot_s": c["snapshot_s"],
                              "write_s": c["write_s"]} for c in saves],
        "first_write_overlaps_next_epoch_s": overlap,
        "peak_device_memory_gib": peak,
        "val_loss": [r["loss"] for r in val_recs],
        "best_step": meta["best"]["step"],
        "evaluate": evals, "best_loss_4_rows": {"kernel": got_loss,
                                                "plain": want_loss},
        "card": card_line()}
    return train_launches, eval_launches, summary, {
        "records": recs, "generations_best": best_generations,
        "step_s": timings["step_s"]}


SERVE_CMD = [sys.executable, "-m", "news_image_caption_tpu_torch.cli",
             "serve", "--http-port", "0", "--max-len", "32"]


def spawned_children(pid: int) -> list:
    """Pids of the live processes that pid started with
    multiprocessing's spawn (the server's sink and workers)."""
    import glob
    out = []
    for stat in glob.glob("/proc/[0-9]*/stat"):
        child = int(stat.split("/")[2])
        try:
            with open(stat) as f:
                fields = f.read().rsplit(")", 1)[1].split()
            with open(f"/proc/{child}/cmdline", "rb") as f:
                cmdline = f.read()
        except OSError:
            continue
        if (int(fields[1]) == pid and fields[0] != "Z"
                and b"spawn_main" in cmdline):
            out.append(child)
    return out


class ServeProcess:
    """The serve command in a subprocess, its stdout and stderr read by
    threads into queues (stderr echoed with a prefix). `stop()` sends
    SIGTERM and returns (rc, seconds); leaving the `with` block stops it
    and kills whatever is left, so no process outlives the script."""

    def __init__(self, cmd):
        import queue
        import threading
        self.lines = {"stdout": queue.Queue(), "stderr": queue.Queue()}
        self.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)
        self.readers = [threading.Thread(target=self._read, args=(name,),
                                         daemon=True)
                        for name in self.lines]
        for t in self.readers:
            t.start()
        self.children: list = []

    def _read(self, name):
        for line in getattr(self.proc, name):
            if name == "stderr":
                print(f"  [serve] {line.rstrip()}", flush=True)
            self.lines[name].put(line)

    def next_line(self, name: str, timeout_s: float, match=None) -> str:
        import queue
        deadline = time.monotonic() + timeout_s
        while True:
            left = deadline - time.monotonic()
            check(left > 0 and self.proc.poll() is None,
                  f"serve: no {name} line{' with ' + match if match else ''}"
                  f" within {timeout_s} s (rc {self.proc.poll()})")
            try:
                line = self.lines[name].get(timeout=min(left, 1.0))
            except queue.Empty:
                continue
            if match is None or match in line:
                return line

    def stop(self, timeout_s: float = 30.0):
        import signal
        self.children = spawned_children(self.proc.pid)
        t = time.perf_counter()
        self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            rc = None
        return rc, time.perf_counter() - t

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        import os
        import signal
        if self.proc.poll() is None:
            self.stop()
        if self.proc.poll() is None:      # SIGTERM did not end it
            self.proc.kill()
        self.proc.wait(timeout=30)
        for pid in self.children:         # anything it left behind
            if _alive(pid):
                os.kill(pid, signal.SIGKILL)
        for t in self.readers:
            t.join(timeout=10)
        return False


def http_encode(port: int, job) -> np.ndarray:
    import urllib.request
    payload = {k: {"data": v.tolist(), "dtype": str(v.dtype)}
               for k, v in job.items()}
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/encode", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        body = json.loads(r.read())
    check(set(body) == {"tokens"}, f"HTTP answered {str(body)[:300]}")
    return np.asarray(body["tokens"], np.int32)


def stack_costs(predict, job) -> dict:
    """Host milliseconds (medians of 5) of what a job pays on its way
    from the client to the decode, in this process: `messages.pack`, one
    socket hop (PUSH -> PULL through `serving/transport.py`; a request
    crosses two such hops going in, client -> server -> worker), and
    `unpack` with `predict.stage` until its copy has ended."""
    import shutil
    from news_image_caption_tpu_torch.serving import transport
    from news_image_caption_tpu_torch.serving.base import auto_bind
    from news_image_caption_tpu_torch.serving.messages import pack, unpack

    dirs = []
    pull = transport.Socket(transport.PULL)
    addr = auto_bind(pull, dirs)
    push = transport.Socket(transport.PUSH)
    push.connect(addr)
    times = {"pack": [], "hop": [], "unpack_stage": []}
    try:
        for _ in range(5):
            t = time.perf_counter()
            frames = pack(job)
            times["pack"].append(time.perf_counter() - t)
            t = time.perf_counter()
            push.send_multipart(frames)
            frames = pull.recv_multipart()
            times["hop"].append(time.perf_counter() - t)
            t = time.perf_counter()
            predict.stage(unpack(frames)).event.synchronize()
            times["unpack_stage"].append(time.perf_counter() - t)
    finally:
        push.close(linger=0)
        pull.close(linger=0)
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)
    return {k: sorted(v)[2] * 1e3 for k, v in times.items()}


def serve_phase(torch, predict, jobs, outputs):
    """Phase 9. `python -m news_image_caption_tpu_torch.cli serve` in a
    subprocess: the flagship at full width and depth in bf16 with the
    random weights of seed 0 (phase 4's), one worker on the card. Every
    token array it serves must equal the in-process `predict`'s for the
    same job (the same card, weights and kernels). Returns the worker's
    launch count of each decode kernel over the jobs and a summary."""
    from news_image_caption_tpu_torch.serving.client import CaptioningClient

    per_step = greedy_launches_a_step()
    cfg = predict.config
    served = []      # the tokens of every job the worker decoded

    def expect(got, want, what):
        check(got.dtype == np.int32 and got.shape == want.shape
              and bool(np.array_equal(got, want)),
              f"serve: {what}: tokens differ from the in-process predict's")
        served.append(got)

    t0 = time.perf_counter()
    with ServeProcess(SERVE_CMD) as serve:
        info = json.loads(serve.next_line("stdout", 120))
        port = json.loads(serve.next_line("stdout", 60))["http_port"]
        check(info["task"] == "flagship" and info["n_workers"] == 1,
              f"serve printed {info}")
        ready = serve.next_line("stderr", 300, match="worker 0 ready")
        ready_s = time.perf_counter() - t0
        name = torch.cuda.get_device_name(0)
        check(name in ready and "cuda" in ready,
              f"the worker's ready line does not name {name}: {ready}")
        print(f"  start to ready: {ready_s:.1f} s", flush=True)
        client = CaptioningClient(info["frontend_addr"],
                                  info["sink_pub_addr"], timeout_ms=300000)
        try:
            stats0 = client.stats(timeout_ms=60000)
            check(stats0["mode"] == "plain" and stats0["jobs_served"] == 0,
                  f"stats before any job: {stats0}")
            # Phase 4's four jobs through the client, two through HTTP.
            for i, (job, want) in enumerate(zip(jobs, outputs)):
                expect(client.caption(job)["tokens"], want, f"job {i}")
            for i in (0, 2):
                expect(http_encode(port, jobs[i]), outputs[i],
                       f"HTTP job {i}")
            # A malformed job is an error reply; the worker serves on.
            bad = {k: v for k, v in jobs[0].items() if k != "article"}
            bad["articel"] = jobs[0]["article"]
            try:
                client.caption(bad)
                fail("serve: a job without 'article' was answered")
            except RuntimeError as e:
                check("KeyError" in str(e), f"serve: error reply {e}")
            expect(client.caption(jobs[1])["tokens"], outputs[1],
                   "job 1 after the error")
            # Eight jobs pipelined, two in flight: submission order.
            rng = np.random.RandomState(9)
            stream_jobs = [make_job(rng, 1, [n])
                           for n in rng.randint(20, 513, size=8)]
            want = [predict(j)["tokens"] for j in stream_jobs]
            got = list(client.caption_stream(iter(stream_jobs), window=2))
            check(len(got) == 8, f"caption_stream yielded {len(got)}")
            for i, (g, w) in enumerate(zip(got, want)):
                expect(g["tokens"], w, f"stream job {i} (in order)")
            # Latency: 20 B=1 requests through the client, each beside
            # the same request through the in-process predict; one B=16.
            rng = np.random.RandomState(10)
            lat_jobs = [make_job(rng, 1, [n])
                        for n in rng.randint(20, 513, size=20)]
            lat = {"client": [], "in_process": []}
            for job in lat_jobs:
                t = time.perf_counter()
                got = client.caption(job)["tokens"]
                lat["client"].append((time.perf_counter() - t) * 1e3)
                t = time.perf_counter()
                want = predict(job)["tokens"]
                lat["in_process"].append((time.perf_counter() - t) * 1e3)
                expect(got, want, "latency job")
            t = time.perf_counter()
            got = client.caption(jobs[3])["tokens"]
            b16_client = (time.perf_counter() - t) * 1e3
            t = time.perf_counter()
            want = predict(jobs[3])["tokens"]
            b16_in_process = (time.perf_counter() - t) * 1e3
            expect(got, want, "B=16 job")
            stats = client.stats(timeout_ms=60000)
        finally:
            client.close()
        rc, stop_s = serve.stop()
        check(rc == 0, f"serve exited with {rc} after SIGTERM")
        check(stop_s <= 30, f"serve took {stop_s:.1f} s to stop")
        check(len(serve.children) == 2,
              f"serve ran {len(serve.children)} spawned processes, expected"
              " the sink and one worker")
        left = [p for p in serve.children if _alive(p)]
        check(not left, f"processes left after serve stopped: {left}")
    check(stats["mode"] == "plain" and stats["jobs_served"] == len(served),
          f"stats {stats}, expected {len(served)} jobs served")
    steps = sum(decode_steps(t, cfg.eos_id, cfg.max_len) for t in served)
    launches = {k: stats["kernel_launches"][k] - stats0["kernel_launches"][k]
                for k in per_step}
    for k, n in launches.items():
        print(f"  {k}: {n} launches in the worker over {steps} steps"
              f" (expected {per_step[k]} per step)")
        check(n == per_step[k] * steps and n > 0,
              f"{k} launched {n} times in the worker, expected"
              f" {per_step[k] * steps}")

    def pct(xs):
        xs = sorted(xs)
        return {"p50": xs[len(xs) // 2], "p90": xs[(9 * len(xs)) // 10]}

    b1 = {k: pct(v) for k, v in lat.items()}
    costs = {"b1": stack_costs(predict, lat_jobs[0]),
             "b16": stack_costs(predict, jobs[3])}
    # What a job pays on its way in, measured in this process: pack, the
    # two hops (client -> server -> worker), unpack and stage.
    way_in = {k: v["pack"] + 2 * v["hop"] + v["unpack_stage"]
              for k, v in costs.items()}
    print(f"  host ms on the way in (pack / one socket hop / unpack and"
          f" stage): { {k: {n: round(x, 3) for n, x in v.items()}
                        for k, v in costs.items()} }; in all B=1"
          f" {way_in['b1']:.3f}, B=16 {way_in['b16']:.3f}", flush=True)
    print(f"  B=1 over 20 requests, client p50 {b1['client']['p50']:.2f} /"
          f" p90 {b1['client']['p90']:.2f} ms, in process p50"
          f" {b1['in_process']['p50']:.2f} / p90 {b1['in_process']['p90']:.2f}"
          f" ms; B=16 {b16_client:.2f} / {b16_in_process:.2f} ms;"
          f" SIGTERM to exit {stop_s:.2f} s", flush=True)
    return launches, {
        "card": card_line(), "start_to_ready_s": ready_s,
        "b1_ms": b1, "b1_ms_all": lat,
        "way_in_host_ms": way_in,
        "way_in_over_b1_in_process_p50":
            way_in["b1"] / b1["in_process"]["p50"],
        "b16_ms": {"client": b16_client, "in_process": b16_in_process},
        "stack_host_ms": costs,
        "jobs_served": stats["jobs_served"], "decode_steps": steps,
        "stop_s": stop_s, "launches": launches}


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def latency_mode(torch, n_requests: int) -> None:
    """`--serving-latency N`: request latency over N requests (host
    clock, request in to tokens on the host; articles of 20-512 tokens,
    max_len 32, early exit): the flagship greedy server at B=1 and B=16,
    then beam-5 (`generate_beam`, the same model and weights, the job
    staged inside the request as the server does) at B=16 and B=128;
    and one profiled request of each: device busy share of the wall
    time, device ms a decode step and the kernels' device time by name.
    Prints one JSON object a path and batch size."""
    from torch.profiler import ProfilerActivity, profile

    from news_image_caption_tpu_torch.generation.generator import \
        GenerationConfig
    from news_image_caption_tpu_torch.serving.worker import \
        flagship_model_builder
    predict = flagship_model_builder("cuda", batch_size=1, max_len=32,
                                     early_exit=True, seed=0)
    cfg = predict.config
    beam_cfg = dataclasses.replace(cfg, beam_size=5)

    def greedy(job):
        return predict(job)["tokens"]

    def beam(job):
        tokens, _ = predict.model.generate_beam(
            stage_batch(torch, job, "cuda"), beam_cfg, predict.weights)
        return tokens.cpu().numpy()

    def steps_of(tokens):
        return decode_steps(tokens.reshape(-1, tokens.shape[-1]),
                            cfg.eos_id, cfg.max_len)

    rngs = {"greedy": np.random.RandomState(0),
            "beam5": np.random.RandomState(1)}
    for path, B, serve in (("greedy", 1, greedy), ("greedy", 16, greedy),
                           ("beam5", 16, beam), ("beam5", 128, beam)):
        rng = rngs[path]
        jobs = [make_job(rng, B, rng.randint(20, 513, size=B))
                for _ in range(n_requests)]
        for job in jobs[:3]:
            serve(job)
        lat, steps = [], 0
        for job in jobs:
            t = time.perf_counter()
            tokens = serve(job)
            lat.append((time.perf_counter() - t) * 1e3)
            steps += steps_of(tokens)
        lat.sort()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            tokens = serve(jobs[0])
            wall = (time.perf_counter() - t) * 1e3
        n = steps_of(tokens)
        dev_events = [e for e in prof.key_averages()
                      if str(e.device_type).endswith("CUDA")]
        busy = sum(e.self_device_time_total for e in dev_events) / 1e3
        check(busy > 0, "the profiler saw no device time")
        top = sorted(dev_events, key=lambda e: -e.self_device_time_total)[:10]
        print(json.dumps({
            "path": path, "B": B, "requests": n_requests,
            "p50_ms": lat[len(lat) // 2], "p90_ms": lat[(9 * len(lat)) // 10],
            "quartiles_ms": [lat[len(lat) // 4], lat[(3 * len(lat)) // 4]],
            "captions_per_s": B * 1e3 / lat[len(lat) // 2],
            "steps_per_request": steps / n_requests,
            "profiled_wall_ms": wall, "device_busy_ms": busy,
            "device_busy_share": busy / wall,
            "device_ms_per_step": busy / n,
            "top_device_ms_per_step": {
                e.key[:60]: [e.self_device_time_total / 1e3 / n, e.count / n]
                for e in top}}), flush=True)


VARIANT_CONFIG = "configs/nytimes/transformer_faces_objects.yaml"
VARIANT_CONTEXTS = ("image", "article", "faces", "obj")
# The evaluate-only variants: their config, and the contexts they attend.
VARIANT_EVALUATE = (("configs/goodnews/transformer_glove.yaml",
                     ("image", "article")),
                    ("configs/goodnews/no_image.yaml", ("article",)))


def variant_kernel_phase(torch, ops):
    """Phase 10, the kernels at the variants' new key counts: S' = 6 (4
    faces or objects, then the bias and zero slots) and S' = 502 (a
    500-token GloVe article), B = 16, bf16. Items 0 and 1 have every
    real row masked, so only the bias and zero slots are attendable (an
    article without a face); the last half have part of theirs masked.
    `decode_cross_attention` at Q = 1 and 5, flash attention forward and
    backward at T = 63 with p = 0.1, held and timed as in phase 3.
    Returns {case: dict(max_abs_err, ms, plain_ms, bound_ms, bound_by,
    library_ms)}, each a call's."""
    xattn, flash = ops
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    B, D, H, T, p = 16, 1024, 16, 63, 0.1
    seed = torch.tensor([4321], dtype=torch.int32, device=dev)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(torch.bfloat16)

    out = {}
    for S in (6, 502):
        k, v = rn(B, S, D), rn(B, S, D)
        k[:, -1] = 0                       # the zero slot
        v[:, -1] = 0
        bias = torch.zeros(B, S, device=dev)
        bias[:2, :S - 2] = -1e9            # items 0 and 1: no real row
        bias[B // 2:, (S - 2) // 2:S - 2] = -1e9
        masked = "items 0-1 with every real row masked"
        for Q in (1, 5):
            tally = Tally()
            attention_case(torch, xattn, f"B={B} Q={Q} S'={S}, {masked}",
                           rn(B, Q, D, scale=0.125), k, v, bias, H, tally)
            out[f"decode_cross_attention B={B} Q={Q} S'={S}"] = \
                tally.result()
        tallies = {"flash_attention_fwd": Tally(),
                   "flash_attention_bwd": Tally()}
        flash_case(torch, flash, f"B={B} T={T} S'={S} p={p}, {masked}",
                   rn(B, T, D, scale=0.125), k, v, rn(B, T, D, scale=0.1),
                   bias, seed, H, p, tallies)
        for name, tally in tallies.items():
            out[f"{name} B={B} T={T} S'={S}"] = tally.result()
    return out


def profiled_busy(torch, fn) -> tuple:
    """(wall ms, device busy ms, fn's result) of fn() under
    torch.profiler, device operations only."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")) / 1e3
    check(busy > 0, "the profiler saw no device time")
    return wall, busy, result


def variant_command_phase(torch, flash, counted):
    """Phase 10, the commands on the faces-and-objects captioner: `train`
    on `VARIANT_CONFIG` at full width and depth with phase 8's cuts and
    the flagship YAML's bf16_o2 and flash switch (which this config
    leaves at fp32 and off), the decoder's dropouts; then `evaluate -m
    best` on 64 test records with the attention dumped. Checks the
    losses, the flash launches (16 forward and 16 backward a train step,
    16 forward a val batch: 4 layers x 4 contexts), the decode launches
    (3 / 16 / 4 / 4 a greedy step), the dumps' faces and objects maps,
    every batch's tokens against the in-process `generate` of the model
    the command decoded, one profiled batch, and one beam-5 B=16 search
    (launches from the plans, scores against teacher forcing). Returns
    the launches and a summary."""
    import tempfile

    from news_image_caption_tpu_torch import cli
    from news_image_caption_tpu_torch.config import (FLAGSHIP,
                                                     build_dataset,
                                                     load_config)
    from news_image_caption_tpu_torch.data.synthetic import CONTEXT_KEYS

    flash_counted = {"flash_attention_fwd": flash.flash_attention_fwd,
                     "flash_attention_bwd": flash.flash_attention_bwd}
    all_counted = {**flash_counted, **counted}
    n_layers, n_ctx = FLAGSHIP["num_layers"], len(VARIANT_CONTEXTS)
    per_step = greedy_launches_a_step(n_ctx)
    launches = dict.fromkeys(all_counted, 0)
    with tempfile.TemporaryDirectory() as tmp:
        out_dir, attn_dir = f"{tmp}/serialization", f"{tmp}/attn"
        overrides = train_command_overrides(out_dir)
        overrides["dataset"]["test"]["size"] = 64
        overrides["trainer"]["mixed_precision"] = "bf16_o2"
        overrides["model"] = {"use_flash_train": True}
        ovr = json.dumps(overrides)
        print(f"  cuts of {VARIANT_CONFIG}: {ovr}", flush=True)
        cfg = load_config(VARIANT_CONFIG, ovr)
        B = cfg["iterator"]["batch_size"]
        n_train = cfg["dataset"]["train"]["size"]
        n_val = cfg["dataset"]["val"]["size"]
        n_test = cfg["dataset"]["test"]["size"]
        epochs = cfg["trainer"]["num_epochs"]
        steps = epochs * (n_train // B)
        val_batches = epochs * (n_val // B)

        timings = {}
        for fn in all_counted.values():
            fn.launches = 0
        t = time.perf_counter()
        rc = cli.main(["train", VARIANT_CONFIG, "-o", ovr], timings=timings)
        wall = time.perf_counter() - t
        check(rc == 0, f"train returned {rc}")
        want = {"flash_attention_fwd": n_ctx * n_layers * (steps
                                                           + val_batches),
                "flash_attention_bwd": n_ctx * n_layers * steps,
                **{n: 0 for n in counted}}
        for name, fn in all_counted.items():
            print(f"  train: {name} {fn.launches} launches (expected"
                  f" {want[name]})")
            check(fn.launches == want[name], f"{name} launched"
                  f" {fn.launches} times in train, expected {want[name]}")
            launches[name] += fn.launches
        with open(f"{out_dir}/metrics.jsonl") as f:
            recs = [json.loads(line) for line in f]
        train_recs = [r for r in recs if r["split"] == "train"]
        check(len(train_recs) == steps // cfg["trainer"]["log_every"]
              and all(np.isfinite(r["loss"]) for r in recs)
              and all(r["skipped"] == 0 for r in train_recs),
              f"train records {recs}")
        step_s = sorted(timings["step_s"])
        step_ms = step_s[len(step_s) // 2] * 1e3
        print("  metrics.jsonl: " + "; ".join(
            f"{r['split']} step {r['step']} loss {r['loss']:.4f}"
            for r in recs) + f"; command {wall:.1f} s, train step median"
            f" {step_ms:.2f} ms (host clock)", flush=True)

        gcfg = cli.generation_config(cfg)
        captured = []
        real = cli.checkpoint_model

        def capture(*args, **kw):
            captured.append(real(*args, **kw))
            return captured[-1]

        cli.checkpoint_model = capture
        eval_timings = {}
        try:
            for fn in all_counted.values():
                fn.launches = 0
            t = time.perf_counter()
            rc = cli.main(["evaluate", VARIANT_CONFIG, "-o", ovr, "-m",
                           "best", "--dump-attention", attn_dir],
                          timings=eval_timings)
            e_wall = time.perf_counter() - t
        finally:
            cli.checkpoint_model = real
        check(rc == 0 and len(captured) == 1, f"evaluate -m best returned"
              f" {rc}")
        tokens = check_evaluate_files(out_dir, attn_dir, n_test // B, gcfg,
                                      n_test, contexts=VARIANT_CONTEXTS,
                                      empty_ok=True)
    n_steps = sum(decode_steps(tk, gcfg.eos_id, gcfg.max_len)
                  for tk in tokens)
    for name, fn in all_counted.items():
        want = per_step.get(name, 0) * n_steps
        print(f"  evaluate -m best: {name} {fn.launches} launches over"
              f" {n_steps} steps (expected {want})")
        check(fn.launches == want, f"evaluate -m best: {name} launched"
              f" {fn.launches} times, expected {want}")
        launches[name] += fn.launches
    print(f"  evaluate -m best: {e_wall:.1f} s, {n_test / e_wall:.2f}"
          f" captions/s; spans (host clock, s)"
          f" { {k: round(v, 3) for k, v in eval_timings.items()} }",
          flush=True)

    # The decoded model in process: every batch's tokens, one profiled
    # batch, one beam-5 search.
    model = captured[0]
    weights = model.decoder.decode_weights()
    staged = []
    for i, batch_np in enumerate(build_dataset(cfg, "test").batches(
            B, shuffle=False)):
        batch = {k: torch.from_numpy(batch_np[k]).cuda()
                 for k in CONTEXT_KEYS if k in batch_np}
        tok, _ = model.generate(batch, gcfg, weights)
        check(bool(np.array_equal(tok.to(torch.int32).cpu().numpy(),
                                  tokens[i])),
              f"batch {i}: in-process generate differs from the command's")
        staged.append(batch)
    b_wall, busy, (prof_tok, _) = profiled_busy(
        torch, lambda: model.generate(staged[0], gcfg, weights))
    n = decode_steps(prof_tok.cpu().numpy(), gcfg.eos_id, gcfg.max_len)
    print(f"  in-process generate equals the command's tokens in all"
          f" {len(staged)} batches; profiled batch: {n} steps, wall"
          f" {b_wall:.1f} ms, device busy {busy:.2f} ms"
          f" ({100 * busy / b_wall:.1f}%), {busy / n:.4f} device ms a step",
          flush=True)

    K = 5
    bcfg = dataclasses.replace(gcfg, max_len=32, beam_size=K)
    beam_per_step = beam_launches_a_step(torch, B * K, K, n_ctx)
    # The steps a search runs (early exit waits for every live beam, not
    # only the returned ones): counted at the decoder's step.
    step_topk, seen = model.decoder.step_topk, []

    def counted_step(*args, **kw):
        seen.append(1)
        return step_topk(*args, **kw)

    model.decoder.step_topk = counted_step
    for fn in counted.values():
        fn.launches = 0
    try:
        t = time.perf_counter()
        btok, bscores = model.generate_beam(staged[0], bcfg, weights)
        btok, bscores = btok.cpu().numpy(), bscores.cpu().numpy()
        beam_ms = (time.perf_counter() - t) * 1e3
    finally:
        del model.decoder.step_topk
    check_beams(btok, bscores, B, bcfg, FLAGSHIP["vocab_size"])
    b_steps = len(seen)
    for name, fn in counted.items():
        check(fn.launches == beam_per_step[name] * b_steps,
              f"beam 5: {name} launched {fn.launches} times, expected"
              f" {beam_per_step[name] * b_steps}")
        launches[name] += fn.launches
    print(f"  beam 5, B={B}: {beam_ms:.1f} ms, {b_steps} steps, launches"
          f" { {n: fn.launches for n, fn in counted.items()} } (plans:"
          f" {beam_per_step} a step)", flush=True)
    check_rescored(torch, model.decoder, staged[0], btok, bscores, bcfg,
                   f"faces and objects, B={B} beam {K}")
    return launches, {
        "config": VARIANT_CONFIG, "cuts": overrides["dataset"] | {
            k: v for k, v in overrides["trainer"].items()
            if k != "serialization_dir"} | overrides["model"],
        "train_steps": steps, "val_batches": val_batches, "train_wall_s": wall,
        "train_step_ms_median": step_ms, "step_s": timings["step_s"],
        "losses": [r["loss"] for r in recs],
        "evaluate": {"records": n_test, "wall_s": e_wall,
                     "captions_per_s": n_test / e_wall,
                     "decode_steps": n_steps, "spans_s": eval_timings},
        "profiled_batch": {"steps": n, "wall_ms": b_wall,
                           "device_busy_ms": busy,
                           "device_busy_share": busy / b_wall,
                           "device_ms_per_step": busy / n},
        "beam5_b16": {"ms": beam_ms, "steps": b_steps}}


def variant_evaluate_phase(torch, counted, path: str, contexts) -> tuple:
    """Phase 10, `evaluate` on a variant's config with random weights
    (the command's own init), full width, 2 batches of 16: the files,
    the dumps' maps, decode launches of 3 / (4 x contexts) / 4 / 4 a
    step. Returns the launches and a summary."""
    import tempfile

    from news_image_caption_tpu_torch import cli
    from news_image_caption_tpu_torch.config import load_config

    per_step = greedy_launches_a_step(len(contexts))
    with tempfile.TemporaryDirectory() as tmp:
        out_dir, attn_dir = f"{tmp}/serialization", f"{tmp}/attn"
        ovr = json.dumps({"dataset": {"test": {"size": 32}},
                          "trainer": {"serialization_dir": out_dir}})
        cfg = load_config(path, ovr)
        gcfg = cli.generation_config(cfg)
        timings = {}
        for fn in counted.values():
            fn.launches = 0
        t = time.perf_counter()
        rc = cli.main(["evaluate", path, "--dump-attention", attn_dir, "-o",
                       ovr], timings=timings)
        wall = time.perf_counter() - t
        check(rc == 0, f"evaluate {path} returned {rc}")
        tokens = check_evaluate_files(out_dir, attn_dir, 2, gcfg, 32,
                                      contexts=contexts)
    steps = sum(decode_steps(tk, gcfg.eos_id, gcfg.max_len) for tk in tokens)
    launches = {}
    for name, fn in counted.items():
        want = per_step[name] * steps
        check(fn.launches == want, f"evaluate {path}: {name} launched"
              f" {fn.launches} times, expected {want}")
        launches[name] = fn.launches
    print(f"  evaluate {path} (contexts {list(contexts)}): {wall:.1f} s,"
          f" {32 / wall:.2f} captions/s, launches {launches} over {steps}"
          f" steps ({per_step} a step)", flush=True)
    return launches, {"config": path, "records": 32, "wall_s": wall,
                      "captions_per_s": 32 / wall, "decode_steps": steps,
                      "spans_s": timings, "launches": launches}


# -- phase 11: speculative greedy, top-k sampling, the slot pool -------------

def conv_positions_phase(torch, blocks):
    """Phase 11.1. `decode_conv_block` with a position a row against its
    plain twin (h 0.02, y 0.05, abs + rel, phase 3's tolerances), bit for
    bit on a second call, at the pool's N = 16 and the beam pool's N = 80
    for the flagship's K = 3/7/15/31, rows at 0, K-2, K-1 and past a
    wrap; every row at one position bit for bit the scalar-t kernel. Times
    the per-row kernel beside the scalar-t kernel (one call each, in
    turns), the plain twin and a library chain with a per-row gather.
    Returns {N: Tally-like dict summed over the four layers}."""
    F_ = torch.nn.functional
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    bf16 = torch.bfloat16

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(bf16)

    D, H = 1024, 16
    w1, b1 = rn(D, 2 * D, scale=D ** -0.5), rn(2 * D, scale=0.05)
    w2, b2 = rn(D, D, scale=D ** -0.5), rn(D, scale=0.05)
    out = {}
    for n in (16, 80):
        tally, scalar_ms = Tally(), 0.0
        for K in (3, 7, 15, 31):
            wl = rn(D, H * K, scale=0.05)
            taps = blocks.pack_taps(wl, H)
            x, cache = rn(n, D), rn(K - 1, n, D, scale=0.5)
            base = torch.tensor([0, K - 2, K - 1, 3 * K + 5], dtype=torch.int32)
            pos = base.repeat(n // 4).to(dev)
            args = (x, cache, pos, w1, b1, wl, w2, b2, H)
            y, h = blocks.decode_conv_block(*args, taps=taps)
            y2, h2 = blocks.decode_conv_block(*args, taps=taps)
            py, ph = blocks.decode_conv_block_plain(*args)
            same = torch.full((n,), 2 * K + 3, dtype=torch.int32, device=dev)
            ya, ha = blocks.decode_conv_block(x, cache, same, w1, b1, wl, w2,
                                              b2, H, taps=taps)
            yt, ht = blocks.decode_conv_block(x, cache, 2 * K + 3, w1, b1, wl,
                                              w2, b2, H, taps=taps)
            torch.cuda.synchronize()
            e_h, ok_h = within(h, ph, 0.02, 0.02)
            e_y, ok_y = within(y, py, 0.05, 0.05)
            check(ok_h and ok_y,
                  f"decode_conv_block per-row positions N={n} K={K} disagrees")
            check(bool(torch.equal(y, y2)) and bool(torch.equal(h, h2)),
                  f"decode_conv_block per-row N={n} K={K}: two calls differ")
            check(bool(torch.equal(ya, yt)) and bool(torch.equal(ha, ht)),
                  f"decode_conv_block N={n} K={K}: one position for every row"
                  " is not the scalar-t kernel bit for bit")
            tally.errs += [e_h, e_y]
            rows = torch.arange(n, device=dev)[None, :]
            slots = (pos.long()[None, :]
                     + torch.arange(K - 1, device=dev)[:, None]) % (K - 1)

            def library():
                hh = F_.glu(F_.linear(x, w1.T, b1), dim=-1)
                p = torch.softmax(F_.linear(hh, wl.T).view(n, H, K), dim=-1)
                hist = torch.cat([cache[slots, rows], hh[None]]).view(
                    K, n, H, D // H)
                conv = torch.einsum("nhk,knhr->nhr", p, hist).reshape(n, D)
                return F_.linear(conv, w2.T, b2) + x, hh
            t_pos = time_ms(lambda: blocks.decode_conv_block(*args, taps=taps))
            t_int = time_ms(lambda: blocks.decode_conv_block(
                x, cache, 2 * K + 3, w1, b1, wl, w2, b2, H, taps=taps))
            t_pos2 = time_ms(lambda: blocks.decode_conv_block(*args,
                                                              taps=taps))
            scalar_ms += t_int
            line = tally.add(
                (x, cache, pos, w1, b1, wl, w2, b2, y, h),
                2.0 * n * D * (2 * D + H * K + D) + 2.0 * n * D * K,
                (t_pos + t_pos2) / 2,
                time_ms(lambda: blocks.decode_conv_block_plain(*args)),
                time_ms(library))
            print(f"  decode_conv_block per-row N={n} K={K}: h {e_h:.3g}, y"
                  f" {e_y:.3g} (tol 0.02 / 0.05); {line}; scalar-t kernel"
                  f" {t_int:.4f} ms (per-row {t_pos:.4f} / {t_pos2:.4f})",
                  flush=True)
        out[n] = dict(tally.result(), scalar_ms=scalar_ms)
    return out


def stack_kvs(torch, per):
    """Per-request lists of each layer's {context: AttentionKV} (or
    `QuantAttentionKV`), stacked into one list over the requests' rows,
    as a slot pool holds them."""
    return [{name: type(kv)(*(torch.cat([p[layer][name][i] for p in per])
                              for i in range(len(kv))))
             for name, kv in per[0][layer].items()}
            for layer in range(len(per[0]))]


def stacked_kvs(torch, model, batches, quantize: bool = False):
    """The context K/V of each request projected alone (batch 1), as the
    slot pool projects them (int8 with quantize), then stacked: the
    yardstick's K/V equal the pool's bit for bit (a product of another
    batch may sum in another order)."""
    return stack_kvs(torch, [model.decoder.precompute_kv(model._contexts(b),
                                                         quantize)
                             for b in batches])


def rows_generate(torch, model, weights, batches, cfg, generator=None):
    """`generate` at B = len(batches) over these requests (K/V projected
    a request, `stacked_kvs`), with cfg's int8 routes: the yardstick of
    the greedy and sampling pools, every kernel at the pool's row
    count."""
    from news_image_caption_tpu_torch.generation.generator import \
        generate_candidates
    with torch.inference_mode():
        kvs = stacked_kvs(torch, model, batches, cfg.quantize_kv)
        tables = model.head_tables(cfg, weights)
        B = len(batches)
        caches = model.decoder.init_cache(B, "cuda")
        seed = torch.full((B,), cfg.bos_id, dtype=torch.long, device="cuda")
        return generate_candidates(
            lambda tok, i: model.decoder.step_topk(
                tok, i, kvs, caches, cfg.sampling_topk, weights,
                tables=tables),
            seed, cfg, generator)


def rows_generate_beam(torch, model, weights, batches, cfg):
    """`generate_beam` at B = len(batches) over these requests (K/V
    projected a request), with cfg's int8 routes: the beam pool's
    yardstick."""
    from news_image_caption_tpu_torch.generation.generator import (
        beam_search_candidates, index_reorder)
    K = cfg.beam_size
    with torch.inference_mode():
        kvs = stacked_kvs(torch, model, batches, cfg.quantize_kv)
        tables = model.head_tables(cfg, weights)
        B = len(batches)
        caches = model.decoder.init_cache(B * K, "cuda")
        seed = torch.full((B,), cfg.bos_id, dtype=torch.long, device="cuda")
        return beam_search_candidates(
            lambda tok, i: model.decoder.step_topk(tok, i, kvs, caches, K,
                                                   weights, beam=K,
                                                   tables=tables),
            seed, cfg, index_reorder(caches))


def counted_run(counted, fn):
    """fn() with every decode kernel's count set to 0 just before and read
    just after: (fn's result, {kernel: launches}, seconds)."""
    import torch
    for k in counted.values():
        k.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, {n: k.launches for n, k in counted.items()}, \
        time.perf_counter() - t


def check_launches(what, launches, per_step, steps):
    for k, n in launches.items():
        want = per_step[k] * steps
        print(f"  {what}: {k} {n} launches over {steps} steps (expected"
              f" {per_step[k]} a step)")
        check(n == want, f"{what}: {k} launched {n} times, expected {want}")


def pool_phase(torch, counted, predict):
    """Phases 11.2 to 11.5: the greedy, beam and sampling pools and
    speculative greedy on phase 4's flagship (bf16, seeded random
    weights), each against the same path run at the pool's row count.
    Returns ({path: launches}, summary)."""
    from news_image_caption_tpu_torch.config import FLAGSHIP
    from news_image_caption_tpu_torch.generation.continuous import (
        ContinuousBatcher, ContinuousBeamBatcher)
    from news_image_caption_tpu_torch.generation.generator import \
        GenerationConfig
    model, weights = predict.model, predict.weights
    V, pad = FLAGSHIP["vocab_size"], 1
    summary, launches = {}, {}
    rng = np.random.RandomState(11)
    jobs = [make_job(rng, 1, [n]) for n in rng.randint(20, 513, size=48)]
    batches = [stage_batch(torch, j, "cuda") for j in jobs]
    caps = rng.randint(8, 33, size=48)
    cfg = GenerationConfig(max_len=32)

    # 11.2 The greedy pool: 16 slots, 8 steps a dispatch, three waves of
    # 16 requests with caps of 8 to 32 tokens, two dispatches apart.
    engine = ContinuousBatcher.for_flattened(model, cfg, 16, weights=weights,
                                             inner_steps=8)

    def greedy_pool():
        ids, res = [], {}
        for w in range(3):
            ids += [engine.submit(b, max_len=int(c)) for b, c in
                    zip(batches[16 * w:16 * w + 16], caps[16 * w:16 * w + 16])]
            res.update(engine.step())
            res.update(engine.step())
        res.update(engine.run())
        return ids, res
    (ids, res), n, secs = counted_run(counted, greedy_pool)
    steps = engine.n_chunks * engine.inner_steps
    check_launches("greedy pool", n, greedy_launches_a_step(), steps)
    launches["greedy_pool"] = n
    check(sorted(res) == sorted(ids), "greedy pool: not every request back")
    same = 0
    for w in range(3):
        want, want_lp = rows_generate(torch, model, weights,
                                      batches[16 * w:16 * w + 16], cfg)
        want, want_lp = want.cpu().numpy(), want_lp.cpu().numpy()
        for r in range(16):
            i = 16 * w + r
            exp = want[r].copy()
            exp[caps[i] + 1:] = pad
            got_t, got_lp = res[ids[i]]
            check(bool(np.array_equal(got_t, exp)),
                  f"greedy pool: request {i} (cap {caps[i]}) differs from its"
                  f" row of generate at B=16: {got_t[:12]} vs {exp[:12]}")
            same += bool(np.array_equal(got_lp[:caps[i]],
                                        want_lp[r, :caps[i]]))
    check(same == 48, f"greedy pool: log-probs of {48 - same} requests differ"
          " from their rows of generate at B=16")
    tokens = int(sum(caps))
    summary["greedy_pool"] = {
        "slots": 16, "inner_steps": 8, "requests": 48, "tokens": tokens,
        "dispatches": engine.n_chunks, "steps": steps, "wall_s": secs,
        "tokens_per_s": tokens / secs, "captions_per_s": 48 / secs,
        "occupancy": engine.occupancy, "ms_per_step": secs * 1e3 / steps}
    print(f"  greedy pool: 48 requests (caps 8-32, three waves) equal to"
          f" their rows of generate at B=16, tokens and log-probs; "
          f"{engine.n_chunks} dispatches, {secs:.2f} s, {tokens / secs:.1f}"
          f" tokens/s, occupancy {engine.occupancy:.3f}", flush=True)
    del engine

    # 11.3 The beam pool: 8 slots of 5 rows, 16 requests.
    bcfg = GenerationConfig(max_len=32, beam_size=5, early_exit=True)
    engine = ContinuousBeamBatcher(model, bcfg, 8, weights=weights,
                                   inner_steps=8)
    (ids, res), n, secs = counted_run(counted, lambda: (
        [engine.submit(b) for b in batches[:16]], engine.run()))
    steps = engine.n_chunks * engine.inner_steps
    check_launches("beam pool", n, beam_launches_a_step(torch, 40, 5), steps)
    launches["beam_pool"] = n
    for w in range(2):
        want_t, want_s = rows_generate_beam(torch, model, weights,
                                            batches[8 * w:8 * w + 8], bcfg)
        for r in range(8):
            got_t, got_s = res[ids[8 * w + r]]
            check(bool(np.array_equal(got_t, want_t[r].cpu().numpy()))
                  and bool(np.array_equal(got_s, want_s[r].cpu().numpy())),
                  f"beam pool: request {8 * w + r} differs from its row of"
                  " generate_beam at B=8")
    summary["beam_pool"] = {"slots": 8, "rows": 40, "requests": 16,
                            "dispatches": engine.n_chunks, "steps": steps,
                            "wall_s": secs, "captions_per_s": 16 / secs}
    print(f"  beam pool: 16 requests equal to their rows of generate_beam at"
          f" B=8 (tokens [5, 33], scores bit for bit); {engine.n_chunks}"
          f" dispatches, {secs:.2f} s", flush=True)
    del engine

    # 11.4 The sampling pool: top-4 at temperature 0.8, a seed a request.
    scfg = GenerationConfig(max_len=32, sampling_topk=4, sampling_temp=0.8)
    engine = ContinuousBatcher.for_flattened(model, scfg, 16,
                                             weights=weights, inner_steps=8)
    seeds = [2000 + i for i in range(16)]

    def gens():
        return [torch.Generator(device="cuda").manual_seed(s) for s in seeds]
    (ids, res), n, secs = counted_run(counted, lambda: (
        [engine.submit(b, generator=g)
         for b, g in zip(batches[16:32], gens())], engine.run()))
    steps = engine.n_chunks * engine.inner_steps
    check_launches("sampling pool", n, greedy_launches_a_step(), steps)
    launches["sampling_pool"] = n
    want, _ = rows_generate(torch, model, weights, batches[16:32], scfg,
                            gens())
    greedy, _ = rows_generate(torch, model, weights, batches[16:32], cfg)
    want, greedy = want.cpu().numpy(), greedy.cpu().numpy()
    for r in range(16):
        check(bool(np.array_equal(res[ids[r]][0], want[r])),
              f"sampling pool: request {r} differs from its row of generate"
              " at B=16 with its generator")
    differ = float((want[:, 1:] != greedy[:, 1:]).mean())
    check(differ > 0, "sampling pool: every token is greedy's")
    summary["sampling_pool"] = {"slots": 16, "requests": 16, "topk": 4,
                                "temp": 0.8, "dispatches": engine.n_chunks,
                                "wall_s": secs,
                                "tokens_unlike_greedy": differ}
    print(f"  sampling pool: 16 seeded requests equal to their rows of"
          f" generate at B=16 with one generator a row; {differ:.3f} of the"
          f" tokens differ from greedy's; {secs:.2f} s", flush=True)
    del engine

    # 11.5 Speculative greedy at B=16, spec_k 4: oracle drafts (the card's
    # own greedy caption as article_ids) and the synthetic article's ids.
    from news_image_caption_tpu_torch.config import (build_dataset,
                                                     load_config)
    batch16 = {k: torch.cat([b[k] for b in batches[:16]])
               for k in batches[0]}
    (greedy16, _), _, g_secs = counted_run(
        counted, lambda: model.generate(batch16, cfg, weights))
    greedy16 = greedy16.cpu()
    article = next(build_dataset(load_config(EVAL_CONFIG), "test").batches(
        16, shuffle=False))["article_ids"]
    # A chunk of 4 at B=16: the conv block position by position (4 a
    # layer), one attention a layer and context (Q = 4), the FFN and the
    # head on 64 rows.
    spec_per_chunk = {"band_topk_lse": 3, "decode_cross_attention": 8,
                      "decode_conv_block": 16, "decode_ffn_block": 16}
    spec_tokens = []
    for name, source in (("oracle", greedy16),
                         ("ngram_article", torch.from_numpy(article))):
        (toks, lps, chunks), n, secs = counted_run(
            counted, lambda: model.generate_speculative(
                dict(batch16, article_ids=source.cuda()), cfg, weights,
                spec_k=4))
        check_launches(f"speculative ({name})", n, spec_per_chunk, chunks)
        launches[f"speculative_{name}"] = n
        toks = toks.cpu()
        check_tokens(toks.numpy(), 16, cfg, V)
        spec_tokens.append(toks)
        check(bool(torch.equal(toks, spec_tokens[0])),
              f"speculative ({name}): the drafts changed the tokens")
        agree16 = (toks[:, 1:17] == greedy16[:, 1:17]).float().mean().item()
        agree = (toks[:, 1:] == greedy16[:, 1:]).float().mean().item()
        summary[f"speculative_{name}"] = {
            "B": 16, "spec_k": 4, "chunks": chunks, "greedy_steps": 32,
            "agree_16_steps": agree16, "agree_32_steps": agree,
            "wall_s": secs, "greedy_wall_s": g_secs}
        print(f"  speculative ({name}): {chunks} chunks against 32 greedy"
              f" steps; tokens equal to greedy's {agree16:.3f} over 16 steps,"
              f" {agree:.3f} over 32; {secs:.2f} s against greedy's"
              f" {g_secs:.2f} s", flush=True)
    oracle = summary["speculative_oracle"]
    check(oracle["chunks"] < 32, "speculative with oracle drafts took as many"
          " chunks as greedy steps")
    check(oracle["agree_16_steps"] >= 0.891,
          f"speculative (oracle) agrees with greedy on"
          f" {oracle['agree_16_steps']:.3f} of 16 steps, below 0.891 (bf16"
          " against fp32, phase 7)")

    return launches, summary


def serve_continuous_phase(torch, predict, plain_b1_ms):
    """Phase 11.6. `serve --continuous-slots 8` in a subprocess (phase 4's
    seeded weights): phase 9's 20 B=1 latency jobs one at a time, then
    all 20 with 8 in flight, through the client; every token array equal
    to an in-process pool's over the same weights; the worker's launches
    from its stats RPC; SIGTERM. Returns (launches, summary)."""
    from news_image_caption_tpu_torch.generation.continuous import \
        ContinuousBatcher
    from news_image_caption_tpu_torch.serving.client import CaptioningClient

    rng = np.random.RandomState(10)          # phase 9's latency jobs
    jobs = [make_job(rng, 1, [n]) for n in rng.randint(20, 513, size=20)]
    local = ContinuousBatcher.for_flattened(predict.model, predict.config, 8,
                                            weights=predict.weights,
                                            inner_steps=8)
    ids = [local.submit(stage_batch(torch, j, "cuda")) for j in jobs]
    res = local.run()
    want = [res[i][0][None].astype(np.int32) for i in ids]
    del local
    per_step = greedy_launches_a_step()
    t0 = time.perf_counter()
    with ServeProcess(SERVE_CMD + ["--continuous-slots", "8"]) as serve:
        info = json.loads(serve.next_line("stdout", 120))
        serve.next_line("stdout", 60)                    # the http port
        serve.next_line("stderr", 300, match="worker 0 ready")
        ready_s = time.perf_counter() - t0
        client = CaptioningClient(info["frontend_addr"],
                                  info["sink_pub_addr"], timeout_ms=300000)
        try:
            stats0 = client.stats(timeout_ms=60000)
            check(stats0["mode"] == "continuous" and stats0["slots"] == 8
                  and stats0["n_chunks"] == 0, f"stats: {stats0}")
            lat = []
            for i, job in enumerate(jobs):
                t = time.perf_counter()
                got = client.caption(job)["tokens"]
                lat.append((time.perf_counter() - t) * 1e3)
                check(bool(np.array_equal(got, want[i])),
                      f"serve --continuous-slots: job {i} differs from the"
                      " in-process pool's")
            t = time.perf_counter()
            got = list(client.caption_stream(iter(jobs), window=8))
            stream_s = time.perf_counter() - t
            for i, g in enumerate(got):
                check(bool(np.array_equal(g["tokens"], want[i])),
                      f"serve --continuous-slots: streamed job {i} differs")
            stats = client.stats(timeout_ms=60000)
        finally:
            client.close()
        rc, stop_s = serve.stop()
        check(rc == 0, f"serve --continuous-slots exited with {rc}")
        left = [p for p in serve.children if _alive(p)]
        check(not left, f"processes left after serve stopped: {left}")
    steps = (stats["n_chunks"] - stats0["n_chunks"]) * stats["inner_steps"]
    launches = {k: stats["kernel_launches"][k] - stats0["kernel_launches"][k]
                for k in per_step}
    check_launches("serve --continuous-slots (worker)", launches, per_step,
                   steps)
    lat_s = sorted(lat)
    b1 = {"p50": lat_s[10], "p90": lat_s[18]}
    print(f"  serve --continuous-slots 8: B=1 one at a time p50 {b1['p50']:.2f}"
          f" / p90 {b1['p90']:.2f} ms (phase 9's plain worker:"
          f" {plain_b1_ms['p50']:.2f} / {plain_b1_ms['p90']:.2f}); 20 jobs 8"
          f" in flight {stream_s:.2f} s ({20 / stream_s:.1f} captions/s);"
          f" start to ready {ready_s:.1f} s", flush=True)
    return launches, {"b1_ms": b1, "plain_worker_b1_ms": plain_b1_ms,
                      "b1_ms_all": lat, "stream_8_in_flight_s": stream_s,
                      "stream_captions_per_s": 20 / stream_s,
                      "start_to_ready_s": ready_s, "steps": steps,
                      "stop_s": stop_s}


# -- phase 12: the pointer family ---------------------------------------------

POINTER_CONFIG = "configs/nytimes/copy_loss.yaml"
# The configs decoded once each with random weights, and their contexts.
POINTER_GREEDY = (("configs/goodnews/only_pointer.yaml", 2),
                  ("configs/goodnews/faces_pointer.yaml", 3))
# A speculative chunk of 4 at B=16 (phase 11's): the conv block position
# by position, one attention a layer and context (Q = 4), the FFN and
# the head's band top-1 on 64 rows.
CHUNK4_B16 = {"band_topk_lse": 3, "decode_cross_attention": 8,
              "decode_conv_block": 16, "decode_ffn_block": 16}
# Phase 12's greedy step at B=16 when the generated token came from
# full-vocab products (PERF.md §6; H100 80GB HBM3, 700.00 W).
POINTER_STEP_MS_FULL_VOCAB = 1.4465


def pointer_steps(torch, model, tree, cfg, weights):
    """Greedy `pointer_chunk` steps of k = 1 over the rows of `tree` (the
    head and gate of speculative decoding and the pool, a position at a
    time): (tokens [B, max_len + 1], copied_flags [B, max_len]), the
    yardstick of `generate_speculative` and `for_pointer`."""
    with torch.inference_mode():
        B = tree["context_ids"].shape[0]
        dev = tree["context_ids"].device
        caches = model.pointer_caches(B, cfg.max_len + 1, dev)
        tokens = torch.full((B, cfg.max_len + 1), cfg.pad_id,
                            dtype=torch.long, device=dev)
        tokens[:, 0] = cfg.bos_id
        flags = torch.zeros(B, cfg.max_len, dtype=torch.bool, device=dev)
        pos = torch.zeros(B, dtype=torch.int32, device=dev)
        finished = torch.zeros(B, dtype=torch.bool, device=dev)
        for i in range(cfg.max_len):
            if bool(finished.all()):
                break
            _, ids, aux, fl = model.pointer_chunk(
                tokens[:, i:i + 1], pos, tree, caches, cfg.eos_id, weights)
            live = ~finished
            tokens[:, i + 1] = torch.where(live, ids[:, 0], cfg.pad_id)
            flags[:, i] = fl[:, 0] & live
            model.pointer_commit(caches, aux, live.to(torch.int32), pos)
            pos += live.to(torch.int32)
            finished |= live & (ids[:, 0] == cfg.eos_id)
        return tokens, flags


def staged_batches(torch, cfg, split: str, B: int):
    """The split's batches of B staged as the evaluate command stages
    them (`CONTEXT_KEYS`, features fp32 on the card)."""
    from news_image_caption_tpu_torch.config import build_dataset
    from news_image_caption_tpu_torch.data.synthetic import CONTEXT_KEYS
    return [({k: torch.from_numpy(b[k]).cuda() for k in CONTEXT_KEYS
              if k in b}, b["caption_ids"])
            for b in build_dataset(cfg, split).batches(B, shuffle=False)]


def pointer_records(tokens: np.ndarray, flags: np.ndarray, captions):
    """(generation, copied_texts) a row, as the evaluate command writes
    them: flags[b, t] marks tokens[b, t + 1]."""
    from news_image_caption_tpu_torch.cli import _texts
    out = []
    for b in range(tokens.shape[0]):
        gen_text, _ = _texts(tokens[b], captions[b])
        out.append((gen_text, " ".join(
            f"w{tokens[b, t + 1]}" for t in range(flags.shape[1])
            if flags[b, t])))
    return out


def check_copies(tokens: np.ndarray, flags: np.ndarray, batch, what: str):
    """Every flagged token one of its row's relevant article ids, none
    flagged twice in a caption. Returns the flags' count."""
    ids = batch["article_ids"].cpu().numpy()
    relevant = batch["context_proper_masks"].cpu().numpy() >= 1
    for b in range(tokens.shape[0]):
        copied = tokens[b, 1:][flags[b]].tolist()
        check(set(copied) <= set(ids[b][relevant[b]].tolist()),
              f"{what}: row {b} copied {copied}, not all relevant article"
              " ids")
        check(len(copied) == len(set(copied)),
              f"{what}: row {b} copied a token twice: {copied}")
    return int(flags.sum())


def pointer_phase(torch, flash, counted):
    """Phase 12, the pointer family at full width in bf16. Returns
    ({path: {kernel: launches}}, summary)."""
    import tempfile

    from news_image_caption_tpu_torch import cli
    from news_image_caption_tpu_torch.config import (build_model,
                                                     load_config,
                                                     merge_overrides)
    from news_image_caption_tpu_torch.generation.continuous import (
        ContinuousBatcher, _tree_map)

    flash_counted = {"flash_attention_fwd": flash.flash_attention_fwd,
                     "flash_attention_bwd": flash.flash_attention_bwd}
    all_counted = {**flash_counted, **counted}
    V = 50265
    launches, summary = {}, {"config": POINTER_CONFIG}

    def run(fn):
        return counted_run(all_counted, fn)

    def decode(n):
        return {k: n[k] for k in counted}

    with tempfile.TemporaryDirectory() as tmp:
        # 12.1 The train command: loss weights (1, 1, 1), phase 8's cuts
        # and the flash switch (the config leaves it off).
        out_dir = f"{tmp}/serialization"
        overrides = train_command_overrides(out_dir)
        overrides["model"] = {"use_flash_train": True}
        ovr = json.dumps(overrides)
        print(f"  cuts of {POINTER_CONFIG}: {ovr}", flush=True)
        cfg = load_config(POINTER_CONFIG, ovr)
        check(cfg["model"]["loss_weights"] == [1.0, 1.0, 1.0],
              "the config's loss weights are not (1, 1, 1)")
        B = cfg["iterator"]["batch_size"]
        epochs = cfg["trainer"]["num_epochs"]
        steps = epochs * (cfg["dataset"]["train"]["size"] // B)
        val_batches = epochs * (cfg["dataset"]["val"]["size"] // B)
        n_test = cfg["dataset"]["test"]["size"]
        timings = {}
        rc, n, wall = run(lambda: cli.main(["train", POINTER_CONFIG, "-o",
                                            ovr], timings=timings))
        check(rc == 0, f"train returned {rc}")
        want = {"flash_attention_fwd": 8 * (steps + val_batches),
                "flash_attention_bwd": 8 * steps, **dict.fromkeys(counted, 0)}
        for name in all_counted:
            print(f"  train: {name} {n[name]} launches (expected"
                  f" {want[name]})")
            check(n[name] == want[name], f"pointer train: {name} launched"
                  f" {n[name]} times, expected {want[name]}")
        launches["pointer_train"] = n
        with open(f"{out_dir}/metrics.jsonl") as f:
            recs = [json.loads(line) for line in f]
        train_recs = [r for r in recs if r["split"] == "train"]
        parts = ("gen_loss", "entity_loss", "copy_loss")
        check(len(train_recs) == steps // cfg["trainer"]["log_every"]
              and all(np.isfinite(r["loss"]) for r in recs)
              and all(r["skipped"] == 0 for r in train_recs), f"{recs}")
        for r in train_recs:
            check(all(k in r and np.isfinite(r[k]) and r[k] > 0
                      for k in parts), f"train record without finite parts:"
                  f" {r}")
            total = sum(r[k] for k in parts)
            check(abs(r["loss"] - total) <= 1e-3 * abs(total),
                  f"loss {r['loss']} is not gen + entity + copy {total}")
        step_s = sorted(timings["step_s"])
        step_ms = step_s[len(step_s) // 2] * 1e3
        print("  metrics.jsonl: " + "; ".join(
            f"{r['split']} step {r['step']} loss {r['loss']:.4f}"
            + "".join(f" {k} {r[k]:.4f}" for k in parts if k in r)
            for r in recs) + f"; command {wall:.1f} s, train step median"
            f" {step_ms:.2f} ms (host clock)", flush=True)
        summary["train"] = {
            "cuts": overrides["dataset"] | {
                k: v for k, v in overrides["trainer"].items()
                if k != "serialization_dir"} | overrides["model"],
            "steps": steps, "val_batches": val_batches, "wall_s": wall,
            "step_ms_median": step_ms, "step_s": timings["step_s"],
            "records": [{k: r[k] for k in ("split", "step", "loss") + parts
                         if k in r} for r in recs]}

        # 12.2 evaluate -m best: greedy, then speculative_k 4.
        gcfg = cli.generation_config(cfg)
        captured = []
        real = cli.checkpoint_model

        def capture(*args, **kw):
            captured.append(real(*args, **kw))
            return captured[-1]

        cli.checkpoint_model = capture
        evals = {}
        try:
            for name, extra in (("greedy", {}), ("speculative", {
                    "generation": {"speculative_k": 4}})):
                e_ovr = json.dumps(merge_overrides(overrides, extra))
                suffix = f"_{name}"
                rc, n, e_wall = run(lambda: cli.main([
                    "evaluate", POINTER_CONFIG, "-o", e_ovr, "-m", "best",
                    "-s", suffix]))
                check(rc == 0, f"evaluate ({name}) returned {rc}")
                with open(f"{out_dir}/generations{suffix}.jsonl") as f:
                    recs = [json.loads(line) for line in f]
                check(len(recs) == n_test and all("copied_texts" in r
                                                  for r in recs),
                      f"evaluate ({name}): {len(recs)} records, copied_texts"
                      " on every one expected")
                evals[name] = (recs, n, e_wall)
        finally:
            cli.checkpoint_model = real
        check(len(captured) == 2, "evaluate did not load the checkpoint")
    model = captured[0]
    weights = model.decoder.decode_weights()
    batches = staged_batches(torch, cfg, "test", B)
    per_step, total_steps, total_chunks = greedy_launches_a_step(), 0, 0
    greedy_t, spec_t = [], []
    for name, (recs, n, e_wall) in evals.items():
        for i, (batch, captions) in enumerate(batches):
            with torch.inference_mode():
                if name == "greedy":
                    tok, fl = model.generate(batch, gcfg, weights)
                    total_steps += decode_steps(tok.cpu().numpy(),
                                                gcfg.eos_id, gcfg.max_len)
                    greedy_t.append(tok.cpu())
                else:
                    tok, fl, chunks = model.generate_speculative(
                        batch, gcfg, weights, spec_k=4)
                    total_chunks += chunks
                    spec_t.append(tok.cpu())
            got = [(r["generation"], r["copied_texts"])
                   for r in recs[i * B:(i + 1) * B]]
            check(got == pointer_records(tok.cpu().numpy(), fl.cpu().numpy(),
                                         captions),
                  f"evaluate ({name}): batch {i}'s records differ from the"
                  " in-process decode of the checkpoint")
        want = (per_step if name == "greedy" else CHUNK4_B16)
        units = total_steps if name == "greedy" else total_chunks
        for k in counted:
            check(n[k] == want[k] * units, f"evaluate ({name}): {k} launched"
                  f" {n[k]} times, expected {want[k]} x {units}")
        check(n["flash_attention_fwd"] == n["flash_attention_bwd"] == 0,
              f"evaluate ({name}) launched the flash kernels")
        launches[f"pointer_evaluate_{name}"] = n
        copied = sum(bool(r["copied_texts"]) for r in recs)
        evals[name] = {"wall_s": e_wall, "captions_per_s": n_test / e_wall,
                       ("steps" if name == "greedy" else "chunks"): units,
                       "records_with_copies": copied, "launches": n}
        print(f"  evaluate -m best ({name}): {n_test} records, copied_texts"
              f" on each ({copied} non-empty), {e_wall:.1f} s, records equal"
              f" to the in-process decode, {units}"
              f" {'steps' if name == 'greedy' else 'chunks'}, launches {n}",
              flush=True)
    agree = float(np.mean([(s[:, 1:] == g[:, 1:]).float().mean().item()
                           for s, g in zip(spec_t, greedy_t)]))
    evals["bf16_greedy_tokens_equal_to_speculative"] = agree
    summary["evaluate"] = evals
    print(f"  bf16: {agree:.4f} of greedy `generate`'s tokens equal"
          " speculative's (both take the generated token from the band"
          " kernel; 0.9338 with the full-vocab greedy head)", flush=True)
    check(agree == 1.0, "pointer: greedy and speculative tokens differ")

    # 12.3 The gate forced open (a weight edit in this phase): greedy and
    # speculative at B=16 and max_len 32.
    gate = copy.deepcopy(model)
    with torch.no_grad():
        gate.entity_fc.bias[1] = 1e4
    gweights = gate.decoder.decode_weights()
    cfg32 = dataclasses.replace(gcfg, max_len=32)
    batch0 = batches[0][0]
    (g1, n_g, _) = run(lambda: gate.generate(batch0, cfg32, gweights))
    (s1, n_s, _) = run(lambda: gate.generate_speculative(
        batch0, cfg32, gweights, spec_k=4))
    g2 = gate.generate(batch0, cfg32, gweights)
    s2 = gate.generate_speculative(batch0, cfg32, gweights, spec_k=4)
    check(all(torch.equal(a, b) for a, b in zip(g1, g2)),
          "gate open: a second greedy call differs")
    check(all(torch.equal(a, b) for a, b in zip(s1[:2], s2[:2])),
          "gate open: a second speculative call differs")
    with torch.inference_mode():
        tree = gate.pointer_tree(batch0, gate.decoder.precompute_kv(
            gate._contexts(batch0)))
    (steps_t, steps_f), n_k1, _ = run(lambda: pointer_steps(
        torch, gate, tree, cfg32, gweights))
    check(torch.equal(s1[0], steps_t) and torch.equal(s1[1], steps_f),
          "gate open: speculative tokens or flags differ from sequential"
          " k=1 pointer_chunk steps")
    n_flags = {}
    for what, (tok, fl) in (("greedy", g1), ("speculative", s1[:2])):
        n_flags[what] = check_copies(tok.cpu().numpy(), fl.cpu().numpy(),
                                     batch0, f"gate open, {what}")
    check(n_flags["speculative"] > 0, "gate open: nothing was copied")
    g_steps = decode_steps(g1[0].cpu().numpy(), cfg32.eos_id, cfg32.max_len)
    check_launches("gate open, greedy", decode(n_g),
                   greedy_launches_a_step(), g_steps)
    check_launches("gate open, speculative", decode(n_s), CHUNK4_B16, s1[2])
    launches["pointer_gate_open"] = {k: n_g[k] + n_s[k] + n_k1[k]
                                     for k in all_counted}
    gate_agree = (g1[0][:, 1:] == s1[0][:, 1:]).float().mean().item()
    summary["gate_open"] = {"B": 16, "max_len": 32, "flags": n_flags,
                            "speculative_chunks": s1[2],
                            "greedy_tokens_equal_to_speculative": gate_agree}
    print(f"  gate open, B=16: copied flags greedy {n_flags['greedy']},"
          f" speculative {n_flags['speculative']}, every one a relevant"
          f" article id once a caption; speculative ({s1[2]} chunks) equal"
          f" to k=1 pointer_chunk steps, tokens and flags; second calls"
          f" bit-equal; greedy tokens equal to speculative's {gate_agree:.4f}",
          flush=True)

    # 12.4 for_pointer: 16 slots, 32 requests in two waves, caps 8 to 32,
    # each request its row of k=1 pointer_chunk steps at 16 rows.
    rng = np.random.RandomState(12)
    caps = rng.randint(8, 33, size=32)
    requests = [{k: v[r:r + 1] for k, v in b.items()}
                for b, _ in batches for r in range(B)]
    engine = ContinuousBatcher.for_pointer(gate, cfg32, 16, weights=gweights,
                                           inner_steps=8)

    def pool():
        ids, res = [], {}
        for w in range(2):
            wave = slice(16 * w, 16 * w + 16)
            ids += [engine.submit(q, max_len=int(c))
                    for q, c in zip(requests[wave], caps[wave])]
            res.update(engine.step())
            res.update(engine.step())
        res.update(engine.run())
        return ids, res
    (ids, res), n_p, p_secs = run(pool)
    p_steps = engine.n_chunks * engine.inner_steps
    check_launches("pointer pool", decode(n_p), greedy_launches_a_step(),
                   p_steps)
    launches["pointer_pool"] = n_p
    check(sorted(res) == sorted(ids), "pointer pool: not every request back")
    pool_flags = 0
    for w in range(2):
        with torch.inference_mode():
            trees = [gate.pointer_tree(q, gate.decoder.precompute_kv(
                gate._contexts(q))) for q in requests[16 * w:16 * w + 16]]
            wave = _tree_map(lambda *leaves: torch.cat(leaves), *trees)
        want_t, want_f = pointer_steps(torch, gate, wave, cfg32, gweights)
        want_t, want_f = want_t.cpu().numpy(), want_f.cpu().numpy()
        for r in range(16):
            i = 16 * w + r
            exp_t, exp_f = want_t[r].copy(), want_f[r].copy()
            exp_t[caps[i] + 1:] = 1
            exp_f[caps[i]:] = False
            got_t, _, got_f = res[ids[i]]
            check(bool(np.array_equal(got_t, exp_t))
                  and bool(np.array_equal(got_f, exp_f)),
                  f"pointer pool: request {i} (cap {caps[i]}) differs from"
                  f" its row of k=1 steps at 16 rows")
            pool_flags += int(got_f.sum())
    summary["pool"] = {"slots": 16, "inner_steps": 8, "requests": 32,
                       "dispatches": engine.n_chunks, "steps": p_steps,
                       "wall_s": p_secs, "copied_flags": pool_flags,
                       "occupancy": engine.occupancy}
    print(f"  pointer pool: 32 requests (caps 8-32, two waves) equal to their"
          f" rows of k=1 pointer_chunk steps at 16 rows, tokens and flags"
          f" ({pool_flags} copies); {engine.n_chunks} dispatches,"
          f" {p_secs:.2f} s, occupancy {engine.occupancy:.3f}", flush=True)
    del engine, gate

    # 12.5 transformer_only_pointer and transformer_faces_pointer, one
    # greedy batch each with seeded random weights.
    summary["greedy_batch"] = {}
    for path, n_ctx in POINTER_GREEDY:
        vcfg = load_config(path, json.dumps({"dataset": {"test": {
            "size": 16}}}))
        vmodel = build_model(vcfg, "cuda", torch.bfloat16,
                             torch.Generator(device="cuda").manual_seed(0))
        vmodel.param_module.eval()
        vbatch = staged_batches(torch, vcfg, "test", 16)[0][0]
        vweights = vmodel.decoder.decode_weights()
        (tok, fl), n_v, v_secs = run(lambda: vmodel.generate(vbatch, cfg32,
                                                             vweights))
        tok_np = tok.cpu().numpy()
        check_tokens(tok_np, 16, cfg32, V)
        v_steps = decode_steps(tok_np, cfg32.eos_id, cfg32.max_len)
        check_launches(path, decode(n_v), greedy_launches_a_step(n_ctx),
                       v_steps)
        name = path.split("/")[-1][:-5]
        launches[f"pointer_{name}"] = n_v
        summary["greedy_batch"][name] = {
            "contexts": n_ctx, "steps": v_steps, "wall_s": v_secs,
            "copied_flags": int(fl.sum()), "launches": n_v}
        print(f"  {path}: one B=16 greedy batch, {v_steps} steps,"
              f" {v_secs:.2f} s, {int(fl.sum())} copied flags, launches"
              f" {n_v}", flush=True)
        del vmodel

    # 12.6 Device ms a greedy step of the trained pointer at B=16, and the
    # share the heads take: the same steps without them (the decoder's
    # step and the band top-1 over the pointer's own tokens).
    b_wall, busy, (ptok, _) = profiled_busy(
        torch, lambda: model.generate(batch0, cfg32, weights))
    n_steps = decode_steps(ptok.cpu().numpy(), cfg32.eos_id, cfg32.max_len)

    def decoder_only():
        with torch.inference_mode():
            kvs = model.decoder.precompute_kv(model._contexts(batch0))
            caches = model.decoder.init_cache(16, ptok.device)
            for i in range(n_steps):
                model.decoder.step_topk(ptok[:, i], i, kvs, caches, 1,
                                        weights)
    d_wall, d_busy, _ = profiled_busy(torch, decoder_only)
    step_ms, dec_ms = busy / n_steps, d_busy / n_steps
    summary["greedy_step_b16"] = {
        "steps": n_steps, "wall_ms": b_wall, "device_busy_ms": busy,
        "device_busy_share": busy / b_wall, "device_ms_per_step": step_ms,
        "decoder_only_device_ms_per_step": dec_ms,
        "heads_share_of_step": (step_ms - dec_ms) / step_ms,
        "full_vocab_head_device_ms_per_step": POINTER_STEP_MS_FULL_VOCAB}
    print(f"  pointer greedy B=16: {n_steps} steps, wall {b_wall:.1f} ms,"
          f" device busy {busy:.2f} ms ({100 * busy / b_wall:.1f}%),"
          f" {step_ms:.4f} device ms a step (full-vocab head:"
          f" {POINTER_STEP_MS_FULL_VOCAB}); without the heads {dec_ms:.4f};"
          " heads"
          f" {100 * (step_ms - dec_ms) / step_ms:.1f}% of the step",
          flush=True)
    summary["card"] = card_line()
    return launches, summary


# -- phases 13 and 14: the LSTM and Gen-2 families ---------------------------

LSTM_CONFIG = "configs/goodnews/lstm_roberta.yaml"
LSTM_GREEDY = "configs/goodnews/baseline_glove_lstm.yaml"
GEN2_CONFIG = "configs/goodnews/gen2_roberta.yaml"     # head size 128
GEN2_GREEDY = "configs/goodnews/gen2_word.yaml"        # head size 64
GEN2_LAYERS = 3
# Noam's warmup in the Gen-2 train command: its 30000 would leave 8 steps
# at rates of 1e-7; a cut of the schedule's length, as phase 8 cuts
# t_total.
GEN2_WARMUP = 400


def family_launches_a_step(family: str) -> dict:
    """A greedy step's (or a Gen-2 chunk's) launches: the LSTM's tied
    adaptive head, one band call a band (3); Gen-2's folded head (1
    band) and the image and the article attention of each layer (6); the
    pipeline's, the flagship decoder's (3 / 8 / 4 / 4); TGNC's, the
    mixed heads' bands and the YAML's 4 trunk and 5 head layers a
    kernel each, two attentions a layer (3 / 18 / 9 / 9); Gen-1's folded
    head (1 band)."""
    if family == "pipeline":
        return greedy_launches_a_step()
    if family == "tgnc":
        return {"band_topk_lse": 3, "decode_cross_attention": 18,
                "decode_conv_block": 9, "decode_ffn_block": 9}
    out = dict.fromkeys(("band_topk_lse", "decode_cross_attention",
                         "decode_conv_block", "decode_ffn_block"), 0)
    if family == "lstm":
        out["band_topk_lse"] = 3
    elif family == "gen1":
        out["band_topk_lse"] = 1
    else:
        out.update(band_topk_lse=1, decode_cross_attention=2 * GEN2_LAYERS)
    return out


def first_step(torch, model, batch, k: int = 5, full: bool = False,
               beam: int = 1):
    """Step 0's exact top-k candidates (log-probs, ids) of an LSTM, a
    Gen-2, a TGNC or a Gen-1 model on `batch`, on the batch's device;
    with `full`, also the full-vocab log-probs [B, V] of the same step in
    fp32 (the plain path's yardstick; no decode path forms them). A
    Gen-1 `beam` > 1 is the beam search's step 0: each row tiled beam
    times, B * beam rows."""
    from news_image_caption_tpu_torch.models.gen1 import Gen1Model
    from news_image_caption_tpu_torch.models.tgnc import TGNC
    with torch.inference_mode():
        w = model.decode_weights()
        dev = batch["article"].device
        B = batch["article"].shape[0]
        seed = torch.zeros(B, dtype=torch.long, device=dev)
        if isinstance(model, TGNC):
            dec = model.tg_decoder
            tree = model.prep(batch)
            out = dec.step_topk(seed, 0, tree["kvs"], dec.init_cache(B, dev),
                                tree["template_logits"], k, w)
            lp = None
            if full:                       # the same step, teacher forced
                x = dec.hidden(seed[:, None], model._contexts(batch),
                               tree["template_logits"])[:, 0]
                lp = dec.adaptive_softmax.log_prob(
                    x.float(), dec.embedder.embed_tables())
        elif isinstance(model, Gen1Model):
            holder, feats, _, _, _ = model._setup_decode(batch, w, beam)
            h, _ = model.module.core_step(seed.repeat_interleave(beam),
                                          feats, holder[0])
            out = model.module.head(h, k, w)
            lp = model.module.log_probs(h.float()) if full else None
        elif hasattr(model, "module"):                 # Gen-2
            m = model.module
            x = m._layers(seed[:, None], seed, model.prep(batch),
                          m.init_cache(B, 2, dev))[:, 0]
            out = m.head(x, k, w)
            lp = (torch.log_softmax(m.generator(x.float()), dim=-1)
                  if full else None)
        else:
            x, _ = model.step(model.embed(seed, 0), model.init_state(B),
                              model._contexts(batch))
            tables = model.embedder.embed_tables()
            out = model.adaptive_softmax.topk_log_prob(x, k, tables,
                                                       w.head_table)
            lp = (model.adaptive_softmax.log_prob(x.float(), tables)
                  if full else None)
        return (*out, lp)


def family_vs_plain(torch, model, batch, what: str, n: int = 4,
                    beam: int = 1) -> dict:
    """Step 0 on the card against the same weights' plain path on the
    CPU (bf16), the batch's first n rows (a Gen-1 `beam` > 1: the beam
    search's step 0, n * beam rows): the top-5 log-probs within 0.1
    (phase 4b's tolerance), and the plain path's log-prob of each id the
    card chose within 0.1 of the card's (random weights leave many near
    ties, so the ids themselves are reported, not held)."""
    rows = {k: v[:n] for k, v in batch.items()}
    cpu = copy.deepcopy(model)
    cpu.param_module.to("cpu")
    v_k, i_k, _ = (t if t is None else t.cpu()
                   for t in first_step(torch, model, rows, beam=beam))
    v_p, i_p, lp_p = first_step(torch, cpu,
                                {k: v.cpu() for k, v in rows.items()},
                                full=True, beam=beam)
    e0 = (v_k - v_p).abs().max().item()
    e_ids = (v_k - lp_p.gather(1, i_k)).abs().max().item()
    agree = (i_k == i_p).float().mean().item()
    print(f"  {what}: step 0 on {n * beam} rows, kernel vs plain path on"
          " the CPU:"
          f" top-5 log-probs max |diff| {e0:.4g} (tol 0.1), the plain"
          f" log-prob of the card's ids max |diff| {e_ids:.4g} (tol 0.1),"
          f" ids equal {agree:.3f}", flush=True)
    check(e0 <= 0.1 and e_ids <= 0.1, f"{what}: step 0 of the kernel and"
          " plain paths differ")
    return {"step0_max_abs_diff": e0, "step0_card_ids_max_abs_diff": e_ids,
            "step0_ids_equal": agree}


def family_command(torch, flash, counted, family: str, path: str,
                   overrides: dict, spec: bool):
    """The train command on `path` with `overrides`, then `evaluate -m
    best` greedy and, with `spec`, at `speculative_k: 4`: no kernel in
    training, every record the in-process decode of the checkpoint's
    model, `family_launches_a_step` a step or a chunk, speculative tokens
    greedy's. Returns (launches by path, summary, the decoded model, the
    generation config, the staged test batches)."""
    import tempfile

    from news_image_caption_tpu_torch import cli
    from news_image_caption_tpu_torch.config import (load_config,
                                                     merge_overrides)

    all_counted = {"flash_attention_fwd": flash.flash_attention_fwd,
                   "flash_attention_bwd": flash.flash_attention_bwd,
                   **counted}
    per_step = family_launches_a_step(family)
    launches, summary = {}, {"config": path}

    def run(fn):
        return counted_run(all_counted, fn)

    with tempfile.TemporaryDirectory() as tmp:
        out_dir = f"{tmp}/serialization"
        overrides["trainer"]["serialization_dir"] = out_dir
        ovr = json.dumps(overrides)
        print(f"  cuts of {path}: {ovr}", flush=True)
        cfg = load_config(path, ovr)
        B = cfg["iterator"]["batch_size"]
        epochs = cfg["trainer"]["num_epochs"]
        per_epoch = cfg["dataset"]["train"]["size"] // B
        n_test = cfg["dataset"]["test"]["size"]
        timings = {}
        rc, n, wall = run(lambda: cli.main(["train", path, "-o", ovr],
                                           timings=timings))
        check(rc == 0, f"{family} train returned {rc}")
        check(not any(n.values()), f"{family} train launched {n}: no kernel"
              " is on this train path")
        launches[f"{family}_train"] = n
        with open(f"{out_dir}/metrics.jsonl") as f:
            recs = [json.loads(line) for line in f]
        with open(f"{out_dir}/checkpoints/meta.json") as f:
            meta = json.load(f)
        train_recs = [r for r in recs if r["split"] == "train"]
        check(len(train_recs) == epochs * per_epoch
              // cfg["trainer"]["log_every"]
              and all(np.isfinite(r["loss"]) for r in recs)
              and all(r["skipped"] == 0 for r in train_recs), f"{recs}")
        check([c["step"] for c in meta["checkpoints"]]
              == [per_epoch * (e + 1) for e in range(epochs)],
              f"meta.json checkpoints {meta['checkpoints']}")
        step_s = sorted(timings["step_s"])
        step_ms = step_s[len(step_s) // 2] * 1e3
        precision = cfg["trainer"].get("mixed_precision") or "fp32"
        print(f"  train ({precision}): " + "; ".join(
            f"{r['split']} step {r['step']} loss {r['loss']:.4f}"
            for r in recs) + f"; command {wall:.1f} s, train step median"
            f" {step_ms:.2f} ms (host clock), no kernel launched", flush=True)
        summary["train"] = {
            "precision": precision, "steps": epochs * per_epoch,
            "wall_s": wall, "step_ms_median": step_ms,
            "records": [{k: r[k] for k in ("split", "step", "loss")}
                        for r in recs]}

        gcfg = cli.generation_config(cfg)
        captured = []
        real = cli.checkpoint_model

        def capture(*args, **kw):
            captured.append(real(*args, **kw))
            return captured[-1]

        modes = [("greedy", {})] + ([("speculative", {
            "generation": {"speculative_k": 4}})] if spec else [])
        evals = {}
        cli.checkpoint_model = capture
        try:
            for name, extra in modes:
                e_ovr = json.dumps(merge_overrides(overrides, extra))
                rc, n, e_wall = run(lambda: cli.main([
                    "evaluate", path, "-o", e_ovr, "-m", "best", "-s",
                    f"_{name}"]))
                check(rc == 0, f"{family} evaluate ({name}) returned {rc}")
                with open(f"{out_dir}/generations_{name}.jsonl") as f:
                    recs = [json.loads(line) for line in f]
                check(len(recs) == n_test, f"{family} evaluate ({name}):"
                      f" {len(recs)} records")
                evals[name] = (recs, n, e_wall)
        finally:
            cli.checkpoint_model = real
        check(len(captured) == len(modes), "evaluate did not load the"
              " checkpoint")
    from news_image_caption_tpu_torch.cli import _texts
    model = captured[0]
    weights = model.decode_weights()
    batches = staged_batches(torch, cfg, "test", B)
    tokens = {}
    for name, (recs, n, e_wall) in evals.items():
        units, toks = 0, []
        for i, (batch, captions) in enumerate(batches):
            with torch.inference_mode():
                if name == "greedy":
                    tok, _ = model.generate(batch, gcfg, weights)
                    units += decode_steps(tok.cpu().numpy(), gcfg.eos_id,
                                          gcfg.max_len)
                else:
                    tok, _, chunks = model.generate_speculative(
                        batch, gcfg, weights, spec_k=4)
                    units += chunks
            toks.append(tok.cpu())
            want = [_texts(row, cap)[0]
                    for row, cap in zip(tok.cpu().numpy(), captions)]
            check([r["generation"] for r in recs[i * B:(i + 1) * B]] == want,
                  f"{family} evaluate ({name}): batch {i}'s records differ"
                  " from the in-process decode of the checkpoint")
        check_launches(f"{family} evaluate ({name})",
                       {k: n[k] for k in counted}, per_step, units)
        check(n["flash_attention_fwd"] == n["flash_attention_bwd"] == 0,
              f"{family} evaluate ({name}) launched the flash kernels")
        launches[f"{family}_evaluate_{name}"] = n
        tokens[name] = toks
        evals[name] = {"wall_s": e_wall, "captions_per_s": n_test / e_wall,
                       ("steps" if name == "greedy" else "chunks"): units,
                       "launches": n}
        print(f"  evaluate -m best ({name}): {n_test} records equal to the"
              f" in-process decode, {e_wall:.1f} s, {units}"
              f" {'steps' if name == 'greedy' else 'chunks'}", flush=True)
    if spec:
        agree = float(np.mean([(s == g).float().mean().item() for s, g in
                               zip(tokens["speculative"], tokens["greedy"])]))
        evals["bf16_greedy_tokens_equal_to_speculative"] = agree
        print(f"  bf16: {agree:.4f} of greedy tokens equal speculative's",
              flush=True)
        check(agree == 1.0, f"{family}: greedy and speculative tokens differ")
    summary["evaluate"] = evals
    return launches, summary, model, gcfg, batches


def random_batch_model(torch, path: str):
    """(the config's model in bf16 from weights seeded with 0, a staged
    B=16 test batch, its generation config at max_len 32, the config)."""
    from news_image_caption_tpu_torch import cli
    from news_image_caption_tpu_torch.config import build_model, load_config
    cfg = load_config(path, json.dumps({"dataset": {"test": {"size": 16}}}))
    model = build_model(cfg, "cuda", torch.bfloat16,
                        torch.Generator(device="cuda").manual_seed(0))
    model.param_module.eval()
    batch = staged_batches(torch, cfg, "test", 16)[0][0]
    return model, batch, dataclasses.replace(cli.generation_config(cfg),
                                             max_len=32), cfg


def family_greedy(torch, counted, family: str, path: str, spec: bool):
    """One B=16 batch of `path` from seeded random weights in bf16,
    greedy (and, with `spec`, speculative at spec_k 4, token for token
    greedy's), max_len 32: launches, a second call bit-equal, step 0
    against the plain path, the device ms a step. Returns (launches by
    path, summary, the model, its generation config)."""
    name = path.split("/")[-1][:-5]
    per_step = family_launches_a_step(family)
    model, batch, cfg32, cfg = random_batch_model(torch, path)
    w = model.decode_weights()
    (tok, _), n, secs = counted_run(counted, lambda: model.generate(
        batch, cfg32, w))
    again, _ = model.generate(batch, cfg32, w)
    check(torch.equal(tok, again), f"{path}: a second greedy call differs")
    tok_np = tok.cpu().numpy()
    check_tokens(tok_np, 16, cfg32, cfg["model"]["vocab_size"])
    steps = decode_steps(tok_np, cfg32.eos_id, cfg32.max_len)
    check_launches(path, n, per_step, steps)
    launches = {f"{name}_batch": n}
    summary = {"config": path, "steps": steps, "wall_s": secs,
               "launches": n, **family_vs_plain(torch, model, batch, path)}
    if spec:
        (s_tok, _, chunks), n_s, s_secs = counted_run(
            counted, lambda: model.generate_speculative(batch, cfg32, w,
                                                        spec_k=4))
        check_launches(f"{path} speculative", n_s, per_step, chunks)
        agree = (s_tok == tok).float().mean().item()
        print(f"  {path}: speculative spec_k 4, {chunks} chunks, {s_secs:.2f}"
              f" s; tokens equal to greedy's {agree:.4f}", flush=True)
        check(agree == 1.0, f"{path}: speculative tokens differ from"
              " greedy's")
        launches[f"{name}_speculative"] = n_s
        summary["speculative"] = {"chunks": chunks, "wall_s": s_secs,
                                  "tokens_equal_to_greedy": agree}
    summary.update(device_step(torch, model, batch, cfg32, w, path))
    return launches, summary, model, cfg32


def device_step(torch, model, batch, cfg, w, what: str) -> dict:
    """The device ms a greedy step of one profiled `generate`."""
    wall, busy, (tok, _) = profiled_busy(
        torch, lambda: model.generate(batch, cfg, w))
    steps = decode_steps(tok.cpu().numpy(), cfg.eos_id, cfg.max_len)
    print(f"  {what}: greedy B={tok.shape[0]}, {steps} steps, wall"
          f" {wall:.1f} ms, device busy {busy:.2f} ms"
          f" ({100 * busy / wall:.1f}%), {busy / steps:.4f} device ms a step",
          flush=True)
    return {"profiled_steps": steps, "wall_ms": wall, "device_busy_ms": busy,
            "device_busy_share": busy / wall,
            "device_ms_per_step": busy / steps}


def lstm_phase(torch, flash, counted):
    """Phase 13. Returns ({path: {kernel: launches}}, summary)."""
    launches, summary, model, _, batches = family_command(
        torch, flash, counted, "lstm", LSTM_CONFIG,
        train_command_overrides(""), spec=False)
    summary.update(family_vs_plain(torch, model, batches[0][0], LSTM_CONFIG))
    more, summary["greedy_batch"], _, _ = family_greedy(
        torch, counted, "lstm", LSTM_GREEDY, spec=False)
    launches.update(more)
    summary["card"] = card_line()
    return launches, summary


def gen2_rows_generate(torch, model, weights, requests, cfg):
    """Gen-2's `generate` over these requests at B = len(requests), the
    memory K/V projected a request, as the pool projects them: the
    pool's yardstick."""
    from news_image_caption_tpu_torch.generation.generator import \
        generate_candidates
    with torch.inference_mode():
        kvs = stack_kvs(torch, [model.prep(q) for q in requests])
        B = len(requests)
        caches = model.module.init_cache(B, cfg.max_len + 1, "cuda")
        seed = torch.full((B,), cfg.bos_id, dtype=torch.long, device="cuda")
        return generate_candidates(
            lambda tok, i: model.module.step(tok, i, kvs, caches, 1, weights),
            seed, cfg)


def gen2_phase(torch, flash, counted):
    """Phase 14. Returns ({path: {kernel: launches}}, summary)."""
    from news_image_caption_tpu_torch.generation.continuous import \
        ContinuousBatcher

    overrides = train_command_overrides("")
    overrides["trainer"]["optimizer"] = {"warmup": GEN2_WARMUP}
    launches, summary, model, _, batches = family_command(
        torch, flash, counted, "gen2", GEN2_CONFIG, overrides, spec=True)
    summary.update(family_vs_plain(torch, model, batches[0][0], GEN2_CONFIG))
    # A B=16 batch of each config from random weights (the trained model
    # may end its captions at once): head sizes 128 and 64.
    summary["greedy_batch"] = {}
    for path in (GEN2_CONFIG, GEN2_GREEDY):
        more, summary["greedy_batch"][path], rmodel, cfg32 = family_greedy(
            torch, counted, "gen2", path, spec=True)
        launches.update(more)
        if path == GEN2_CONFIG:
            model, weights = rmodel, rmodel.decode_weights()
    del rmodel

    # for_gen2 over the random gen2_roberta model: 16 slots, 32 requests
    # (the test split's) in two waves, caps 8 to 32, each request its row
    # of `generate` over its wave at 16 rows.
    rng = np.random.RandomState(14)
    caps = rng.randint(8, 33, size=32)
    requests = [{k: v[r:r + 1] for k, v in b.items()}
                for b, _ in batches for r in range(16)]
    engine = ContinuousBatcher.for_gen2(model, cfg32, 16, weights=weights,
                                        inner_steps=8)

    def pool():
        ids, res = [], {}
        for wave in range(2):
            part = slice(16 * wave, 16 * wave + 16)
            ids += [engine.submit(q, max_len=int(c))
                    for q, c in zip(requests[part], caps[part])]
            res.update(engine.step())
            res.update(engine.step())
        res.update(engine.run())
        return ids, res
    (ids, res), n_p, p_secs = counted_run(counted, pool)
    p_steps = engine.n_chunks * engine.inner_steps
    check_launches("gen2 pool", n_p, family_launches_a_step("gen2"), p_steps)
    launches["gen2_pool"] = n_p
    check(sorted(res) == sorted(ids), "gen2 pool: not every request back")
    for wave in range(2):
        want, _ = gen2_rows_generate(torch, model, weights,
                                     requests[16 * wave:16 * wave + 16],
                                     cfg32)
        want = want.cpu().numpy()
        for r in range(16):
            i = 16 * wave + r
            exp = want[r].copy()
            exp[caps[i] + 1:] = cfg32.pad_id
            check(bool(np.array_equal(res[ids[i]][0], exp)),
                  f"gen2 pool: request {i} (cap {caps[i]}) differs from its"
                  " row of generate at 16 rows")
    summary["pool"] = {"slots": 16, "inner_steps": 8, "requests": 32,
                       "dispatches": engine.n_chunks, "steps": p_steps,
                       "wall_s": p_secs, "occupancy": engine.occupancy}
    print(f"  gen2 pool: 32 requests (caps 8-32, two waves) equal to their"
          f" rows of generate at 16 rows; {engine.n_chunks} dispatches,"
          f" {p_secs:.2f} s, occupancy {engine.occupancy:.3f}", flush=True)
    summary["card"] = card_line()
    return launches, summary



# -- phase 15: the online pipeline --------------------------------------------

PIPELINE_CONFIG = "configs/goodnews/transformer_weighted_roberta.yaml"
PIPELINE_OTHER = "configs/nytimes/transformer_weighted_roberta.yaml"


def captioner_vs_plain(torch, captioner, ctx, weights, what: str) -> dict:
    """Step 0 of a flagship-decoder captioner on the card over the
    contexts `ctx` (on the card) against its decoder's plain path on the
    CPU (bf16) over the same contexts: the top-5 log-probs within 0.1 of
    the plain path's full-vocab top-5, and the plain log-prob of each id
    the card chose within 0.1 of the card's (phase 13's tolerances)."""
    from news_image_caption_tpu_torch.generation.generator import \
        GenerationConfig
    from news_image_caption_tpu_torch.models.captioner import \
        TransformerFlattened
    cfg = GenerationConfig(max_len=1)
    cpu = TransformerFlattened(decoder=copy.deepcopy(captioner.decoder).to(
        "cpu"))
    n = ctx["article"].shape[0]
    with torch.inference_mode():
        kvs, caches, seed, w = captioner._decode_setup(ctx, cfg, weights, 1)
        v_k, i_k = (t.cpu() for t in captioner.decoder.step_topk(
            seed, 0, kvs, caches, 5, w))
        kvs, caches, seed, w = cpu._decode_setup(
            {k: v.cpu() for k, v in ctx.items()}, cfg, None, 1)
        lp = cpu.decoder.step(seed, 0, kvs, caches, w).float()
    v_p, i_p = torch.topk(lp, 5, dim=-1)
    e0 = (v_k - v_p).abs().max().item()
    e_ids = (v_k - lp.gather(1, i_k)).abs().max().item()
    agree = (i_k == i_p).float().mean().item()
    print(f"  {what}: step 0 on {n} rows, kernel vs plain path on the CPU"
          f" (the card's contexts): top-5 log-probs max |diff| {e0:.4g} (tol"
          f" 0.1), the plain log-prob of the card's ids max |diff|"
          f" {e_ids:.4g} (tol 0.1), ids equal {agree:.3f}", flush=True)
    check(e0 <= 0.1 and e_ids <= 0.1, f"{what}: step 0 of the kernel and"
          " plain paths differ")
    return {"step0_max_abs_diff": e0, "step0_card_ids_max_abs_diff": e_ids,
            "step0_ids_equal": agree}


def pipeline_vs_plain(torch, model, batch, what: str) -> dict:
    """Step 0 of 4 rows on the card's encode of the raw images and
    article ids against the plain path on the CPU
    (`captioner_vs_plain`)."""
    rows = {k: v[:4] for k, v in batch.items()}
    with torch.inference_mode():
        ctx = model.encode(rows)
    return captioner_vs_plain(torch, model.captioner, ctx,
                              model.decode_weights(), what)


def pipeline_batch(torch, counted, path: str, generator_seed: int = 0):
    """`path`'s model from seeded random weights in bf16 and its first
    B=16 test batch, greedy at max_len 32: tokens checked, launches 3 /
    8 / 4 / 4 a step, a second call bit-equal. Returns (model, batch,
    generation config, weights, launches, summary)."""
    from news_image_caption_tpu_torch import cli
    from news_image_caption_tpu_torch.config import build_model, load_config
    cfg = load_config(path, json.dumps({"dataset": {"test": {"size": 16}}}))
    model = build_model(cfg, "cuda", torch.bfloat16, torch.Generator(
        device="cuda").manual_seed(generator_seed))
    model.eval()
    batch = staged_batches(torch, cfg, "test", 16)[0][0]
    batch = {k: batch[k] for k in model.context_keys}
    w = model.decode_weights()
    cfg32 = dataclasses.replace(cli.generation_config(cfg), max_len=32)
    (tok, _), n, secs = counted_run(counted, lambda: model.generate(
        batch, cfg32, w))
    again, _ = model.generate(batch, cfg32, w)
    check(torch.equal(tok, again), f"{path}: a second greedy call differs")
    tok_np = tok.cpu().numpy()
    check_tokens(tok_np, 16, cfg32, cfg["model"]["decoder"]["vocab_size"])
    steps = decode_steps(tok_np, cfg32.eos_id, cfg32.max_len)
    check_launches(path, n, greedy_launches_a_step(), steps)
    print(f"  {path}: random weights, greedy B=16, {steps} steps,"
          f" {secs:.2f} s", flush=True)
    return model, batch, cfg32, w, n, {"config": path, "steps": steps,
                                       "wall_s": secs, "launches": n}


def top_device_kernels(torch, fn, n: int = 8) -> dict:
    """The device time of one fn() under torch.profiler and its `n`
    costliest kernels: (name cut to 70 characters, ms, calls)."""
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode(), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted((e for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")),
                  key=lambda e: -e.self_device_time_total)
    return {"device_ms": sum(e.self_device_time_total for e in rows) / 1e3,
            "top": [(e.key[:70], e.self_device_time_total / 1e3, e.count)
                    for e in rows[:n]]}


def roberta_attention_parts(torch, layer, x, keep) -> dict:
    """Device ms (CUDA events) of one RoBERTa layer on x and of its
    attention's parts as the port computes them (fp32 scores, their
    scale, mask and softmax), beside the same scores as a bf16 product
    and PyTorch's fused `scaled_dot_product_attention` over the same
    q / k / v and mask (timed here only, used nowhere in the port)."""
    import torch.nn.functional as F
    B, S, H = x.shape
    hd = H // layer.heads

    def split(t):
        return t.view(B, S, layer.heads, hd).transpose(1, 2)

    q, k, v = split(layer.q(x)), split(layer.k(x)), split(layer.v(x))
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    return {
        "layer": time_ms(lambda: layer(x, keep), iters=10),
        "scores_fp32": time_ms(lambda: torch.matmul(
            q.float(), k.float().transpose(-1, -2)), iters=10),
        "scale_mask_softmax_fp32": time_ms(lambda: torch.softmax(
            (scores / hd ** 0.5).masked_fill(~keep[:, None, None, :], -1e9),
            dim=-1).to(v.dtype), iters=10),
        "scores_bf16_product": time_ms(lambda: torch.matmul(
            q, k.transpose(-1, -2)), iters=10),
        "library_fused_attention": time_ms(
            lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=keep[:, None, None, :]), iters=10)}


def pipeline_phase(torch, flash, counted):
    """Phase 15. Returns ({path: {kernel: launches}}, summary)."""
    from news_image_caption_tpu_torch import cli
    from news_image_caption_tpu_torch.models.resnet import preprocess_image

    # The train command's fp32 model, captured as it is built: its
    # frozen encoders before training, and bert_weight.
    seen = {}
    real = cli.training_model

    def capture(cfg, device, seed):
        model = real(cfg, device, seed)
        seen["model"] = model
        seen["frozen"] = {k: p.detach().clone()
                          for k, p in model.named_parameters()
                          if k.split(".")[0] in model.frozen_collections}
        seen["bert_weight"] = model.weighted_sum.bert_weight.detach().clone()
        return model

    cli.training_model = capture
    try:
        launches, summary, model, _, batches = family_command(
            torch, flash, counted, "pipeline", PIPELINE_CONFIG,
            train_command_overrides(""), spec=False)
    finally:
        cli.training_model = real
    trained, frozen = seen["model"], seen["frozen"]
    params = dict(trained.named_parameters())
    check(len(frozen) > 0 and all(torch.equal(params[k], v)
                                  for k, v in frozen.items()),
          "the frozen encoders changed in training")
    bw = trained.weighted_sum.bert_weight.detach()
    moved = (bw - seen["bert_weight"]).abs().max().item()
    check(moved > 0, "bert_weight did not move in training")
    decoded = dict(model.named_parameters())
    check(all(torch.equal(decoded[k], v.to(decoded[k].dtype))
              for k, v in frozen.items()),
          "the decoded checkpoint's encoders differ from the initial ones")
    n_frozen = sum(v.numel() for v in frozen.values())
    print(f"  frozen encoders: {len(frozen)} tensors, {n_frozen} parameters"
          f" bit-equal after training and in the decoded checkpoint (bf16);"
          f" bert_weight moved by up to {moved:.3g}", flush=True)
    summary["frozen"] = {"tensors": len(frozen), "parameters": n_frozen,
                         "bert_weight_max_move": moved}
    del seen, trained, frozen, params, decoded
    summary.update(pipeline_vs_plain(torch, model, batches[0][0],
                                     PIPELINE_CONFIG))
    del model, batches
    torch.cuda.empty_cache()

    # Timing: one B=16 greedy batch from random weights.
    model, batch, cfg32, w, n, summary["greedy_batch"] = pipeline_batch(
        torch, counted, PIPELINE_CONFIG)
    launches["pipeline_batch"] = n
    with torch.inference_mode():
        image = preprocess_image(batch["image"]).to(torch.bfloat16)
        ids = batch["article_ids"]
        _, hiddens = model.roberta(ids)
        enc = {"preprocess": time_ms(lambda: preprocess_image(
                   batch["image"]), iters=10),
               "resnet": time_ms(lambda: model.resnet.patches(image),
                                 iters=10),
               "roberta": time_ms(lambda: model.roberta(ids), iters=10),
               "weighted_sum": time_ms(lambda: model.weighted_sum(hiddens),
                                       iters=10),
               "encode": time_ms(lambda: model.encode(batch), iters=10)}
        attention = roberta_attention_parts(torch, model.roberta.layer_0,
                                            hiddens[0], ids != 1)
        del hiddens
        ctx = model.encode(batch)
    enc_kernels = {part: top_device_kernels(torch, fn) for part, fn in (
        ("resnet", lambda: model.resnet.patches(image)),
        ("roberta", lambda: model.roberta(ids)),
        ("encode", lambda: model.encode(batch)))}
    wall, busy, (tok, _) = profiled_busy(
        torch, lambda: model.captioner.generate(ctx, cfg32, w))
    steps = decode_steps(tok.cpu().numpy(), cfg32.eos_id, cfg32.max_len)
    b_wall, b_busy, _ = profiled_busy(
        torch, lambda: model.generate(batch, cfg32, w))
    print("  encode at B=16, device ms (CUDA events, L2-cold): " + ", ".join(
        f"{k} {v:.4f}" for k, v in enc.items()), flush=True)
    for part, k in enc_kernels.items():
        print(f"  {part}'s device time by kernel (profiler, one call,"
              f" {k['device_ms']:.3f} ms busy): " + "; ".join(
                  f"{name} x{count} {ms:.3f} ms"
                  for name, ms, count in k["top"][:5]), flush=True)
    print("  a RoBERTa layer at B=16, S=512, device ms (CUDA events): " +
          ", ".join(f"{k} {v:.4f}" for k, v in attention.items()),
          flush=True)
    print(f"  decode: {steps} steps, {busy / steps:.4f} device ms a step"
          f" (busy {100 * busy / wall:.1f}% of the decode's wall); the whole"
          f" batch, encode included: wall {b_wall:.1f} ms, device busy"
          f" {b_busy:.2f} ms ({100 * b_busy / b_wall:.1f}%)", flush=True)
    summary["timing"] = {"encode_ms": enc, "encode_kernels": enc_kernels,
                         "roberta_layer_ms": attention,
                         "decode_steps": steps,
                         "device_ms_per_step": busy / steps,
                         "decode_busy_share": busy / wall,
                         "batch_wall_ms": b_wall, "batch_busy_ms": b_busy,
                         "batch_busy_share": b_busy / b_wall}
    del model, batch, ctx, w
    torch.cuda.empty_cache()

    # The other config: builds and decodes a batch.
    _, _, _, _, n, summary["other"] = pipeline_batch(torch, counted,
                                                     PIPELINE_OTHER)
    launches["pipeline_other_batch"] = n
    torch.cuda.empty_cache()
    summary["card"] = card_line()
    return launches, summary


# -- phases 16 and 17: TGNC and Gen-1 -----------------------------------------

TGNC_CONFIG = "configs/goodnews/joganic_tgnc.yaml"
GEN1_CONFIG = "configs/goodnews/gen1_show_attend_tell.yaml"
TGNC_SPEC_K = 4


def tgnc_launches_a_chunk(B: int, k: int) -> dict:
    """A TGNC chunk of k positions at B rows: the conv block a position
    and layer (k launches of the one-token kernel over a copy of the
    ring), the attentions once a layer and context, the FFN one launch
    per 16 of the B*k rows a layer, the bands one per 128."""
    per = family_launches_a_step("tgnc")
    n = per["decode_conv_block"]
    return {"band_topk_lse": per["band_topk_lse"] * -(-B * k // 128),
            "decode_cross_attention": per["decode_cross_attention"],
            "decode_conv_block": n * k * -(-B // 128),
            "decode_ffn_block": n * -(-B * k // 16)}


def events_ms(torch, fn):
    """(fn's result, the ms between CUDA events recorded around it: the
    span of a host-bound call, not its device busy time)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def tgnc_rows_generate(torch, model, weights, requests, cfg):
    """TGNC's `generate` at B = len(requests), each request's K/V and
    template logits computed alone (as `for_tgnc` computes them), then
    stacked: the pool's yardstick."""
    from news_image_caption_tpu_torch.generation.generator import \
        generate_candidates
    dec = model.tg_decoder
    with torch.inference_mode():
        per = [model.prep(q) for q in requests]
        kvs = stack_kvs(torch, [p["kvs"] for p in per])
        logits = torch.cat([p["template_logits"] for p in per])
        B = len(requests)
        caches = dec.init_cache(B, "cuda")
        seed = torch.full((B,), cfg.bos_id, dtype=torch.long, device="cuda")
        return generate_candidates(
            lambda tok, i: dec.step_topk(tok, i, kvs, caches, logits, 1,
                                         weights), seed, cfg)


def tgnc_phase(torch, flash, counted):
    """Phase 16. Returns ({path: {kernel: launches}}, summary)."""
    from news_image_caption_tpu_torch.generation.continuous import \
        ContinuousBatcher

    launches, summary, trained, _, batches = family_command(
        torch, flash, counted, "tgnc", TGNC_CONFIG,
        train_command_overrides(""), spec=False)
    del trained, batches
    model, batch, cfg32, _ = random_batch_model(torch, TGNC_CONFIG)
    w = model.decode_weights()
    per_step = family_launches_a_step("tgnc")
    (tok, _), n, secs = counted_run(counted, lambda: model.generate(
        batch, cfg32, w))
    again, _ = model.generate(batch, cfg32, w)
    check(torch.equal(tok, again), "tgnc: a second greedy call differs")
    tok_np = tok.cpu().numpy()
    check_tokens(tok_np, 16, cfg32, model.tg_decoder.vocab_size)
    steps = decode_steps(tok_np, cfg32.eos_id, cfg32.max_len)
    check_launches("tgnc greedy B=16", n, per_step, steps)
    launches["tgnc_batch"] = n
    _, ev_ms = events_ms(torch, lambda: model.generate(batch, cfg32, w))
    greedy = {"steps": steps, "wall_s": secs, "launches": n,
              "launches_a_step": per_step,
              "events_ms_per_step": ev_ms / steps,
              **device_step(torch, model, batch, cfg32, w, TGNC_CONFIG)}
    print(f"  tgnc greedy B=16: {steps} steps, {ev_ms / steps:.4f} ms between"
          " CUDA events a step", flush=True)

    # Speculative greedy with oracle drafts (the card's greedy caption).
    oracle = dict(batch, article_ids=tok[:, 1:].contiguous())
    (s_tok, _, chunks), n_s, s_secs = counted_run(
        counted, lambda: model.generate_speculative(
            oracle, cfg32, w, spec_k=TGNC_SPEC_K))
    check_launches("tgnc speculative", n_s,
                   tgnc_launches_a_chunk(16, TGNC_SPEC_K), chunks)
    agree = (s_tok == tok).float().mean().item()
    print(f"  tgnc speculative spec_k {TGNC_SPEC_K}, oracle drafts: {chunks}"
          f" chunks for {steps} steps, {s_secs:.2f} s; tokens equal to"
          f" greedy's {agree:.4f}", flush=True)
    check(agree == 1.0, "tgnc: speculative tokens differ from greedy's")
    launches["tgnc_speculative"] = n_s

    # for_tgnc: 16 slots, the batch's 16 rows as requests, each its row of
    # `generate` at 16 rows over the same per-request K/V and logits.
    requests = [{k: v[r:r + 1] for k, v in batch.items()
                 if k != "article_ids"} for r in range(16)]
    engine = ContinuousBatcher.for_tgnc(model, cfg32, 16, weights=w,
                                        inner_steps=8)

    def pool():
        ids = [engine.submit(q) for q in requests]
        return ids, engine.run()
    (ids, res), n_p, p_secs = counted_run(counted, pool)
    p_steps = engine.n_chunks * engine.inner_steps
    check_launches("tgnc pool", n_p, tgnc_launches_a_chunk(16, 1),
                   p_steps)
    launches["tgnc_pool"] = n_p
    want, _ = tgnc_rows_generate(torch, model, w, requests, cfg32)
    want = want.cpu().numpy()
    for r in range(16):
        check(bool(np.array_equal(res[ids[r]][0], want[r])),
              f"tgnc pool: request {r} differs from its row of generate at"
              " 16 rows")
    print(f"  tgnc pool: 16 requests equal to their rows of generate at 16"
          f" rows; {engine.n_chunks} dispatches, {p_secs:.2f} s", flush=True)
    summary["greedy_batch"] = {
        **greedy, "speculative": {"spec_k": TGNC_SPEC_K, "chunks": chunks,
                                  "wall_s": s_secs,
                                  "tokens_equal_to_greedy": agree},
        "pool": {"slots": 16, "requests": 16, "dispatches": engine.n_chunks,
                 "wall_s": p_secs},
        **family_vs_plain(torch, model, batch, TGNC_CONFIG)}
    summary["card"] = card_line()
    return launches, summary


def gen1_phase(torch, flash, counted):
    """Phase 17. Returns ({path: {kernel: launches}}, summary)."""
    overrides = train_command_overrides("")
    del overrides["trainer"]["optimizer"]      # gen1_adam has no t_total
    launches, summary, trained, _, batches = family_command(
        torch, flash, counted, "gen1", GEN1_CONFIG, overrides, spec=False)
    summary.update(family_vs_plain(torch, trained, batches[0][0],
                                   GEN1_CONFIG))
    del trained, batches
    model, batch, cfg32, _ = random_batch_model(torch, GEN1_CONFIG)
    w = model.decode_weights()
    V1 = model.module.vocab_size + 1
    seq_len = model.module.seq_length
    band = family_launches_a_step("gen1")

    # Beam 5 at B=16: 80 rows, one band launch a step, seq_length steps.
    (b_tok, b_score), n_b, b_secs = counted_run(
        counted, lambda: model.sample_beam(batch, beam_size=5))
    check(tuple(b_tok.shape) == (16, seq_len)
          and bool(((b_tok >= 0) & (b_tok < V1)).all())
          and bool(torch.isfinite(b_score).all()),
          f"gen1 beam: tokens {tuple(b_tok.shape)}, scores {b_score}")
    check_launches("gen1 beam 5 B=16", n_b, band, seq_len)
    launches["gen1_beam5"] = n_b
    beam_step0 = family_vs_plain(torch, model, batch,
                                 f"{GEN1_CONFIG} beam 5", n=16, beam=5)

    # sample_with_attention: greedy, the maps' rows sum to 1.
    (a_tok, a_lp, (vis, sen)), n_a, a_secs = counted_run(
        counted, lambda: model.sample_with_attention(batch))
    P = batch["image"].shape[1]
    S = batch["article"].shape[1]
    check(tuple(vis.shape) == (seq_len, 16, P)
          and tuple(sen.shape) == (seq_len, 16, S), f"gen1 maps {vis.shape}"
          f" {sen.shape}")
    e_vis = (vis.float().sum(-1) - 1).abs().max().item()
    e_sen = (sen.float().sum(-1) - 1).abs().max().item()
    check(e_vis <= 1e-2 and e_sen <= 1e-2, f"gen1 maps' rows sum to 1 within"
          f" {e_vis:.3g} / {e_sen:.3g}")
    check_launches("gen1 sample_with_attention", n_a, band, seq_len)
    launches["gen1_attention"] = n_a
    g_tok, _ = model.sample(batch)
    check(torch.equal(g_tok, a_tok), "gen1: sample_with_attention's tokens"
          " differ from sample's")

    # Greedy at B=16: the device ms a step.
    (tok, _), n, secs = counted_run(counted, lambda: model.generate(
        batch, cfg32, w))
    steps = decode_steps(tok.cpu().numpy(), cfg32.eos_id, cfg32.max_len)
    check_launches("gen1 greedy B=16", n, band, steps)
    launches["gen1_batch"] = n
    _, ev_ms = events_ms(torch, lambda: model.generate(batch, cfg32, w))
    print(f"  gen1: beam 5 B=16 {b_secs:.2f} s, sample_with_attention"
          f" {a_secs:.2f} s (maps' rows sum to 1 within {e_vis:.2g} /"
          f" {e_sen:.2g}), greedy B=16 {steps} steps,"
          f" {ev_ms / steps:.4f} ms between CUDA events a step", flush=True)
    summary["greedy_batch"] = {
        "steps": steps, "wall_s": secs, "launches": n,
        "events_ms_per_step": ev_ms / steps,
        "beam5": {"wall_s": b_secs, "launches": n_b, **beam_step0},
        "sample_with_attention": {"wall_s": a_secs, "launches": n_a,
                                  "vis_row_sum_err": e_vis,
                                  "sen_row_sum_err": e_sen},
        **device_step(torch, model, batch, cfg32, w, GEN1_CONFIG),
        **family_vs_plain(torch, model, batch, GEN1_CONFIG)}
    summary["card"] = card_line()
    return launches, summary


PEOPLE = ("Barack Obama", "Angela Merkel", "Emmanuel Macron",
          "Jacinda Ardern", "José Mujica", "Narendra Modi", "Serena Williams",
          "Lionel Messi")
PLACES = ("Paris", "New York", "Berlin", "Wellington", "Montevideo",
          "New Delhi", "London", "Buenos Aires")


def news_records(n: int, seed: int = 0) -> list:
    """n news records whose captions and articles name people and
    places (seeded), about 150 words an article."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        who, other = (PEOPLE[j] for j in rng.permutation(len(PEOPLE))[:2])
        where, there = (PLACES[j] for j in rng.permutation(len(PLACES))[:2])
        day = int(rng.integers(1, 29))
        sentences = [
            f"{who} arrived in {where} on March {day} for talks with"
            f" {other}.",
            f"Officials in {where} said the visit had been planned for"
            f" months, and crowds gathered near the station.",
            f"{other} told reporters in {there} that the meeting would"
            f" cover trade, climate and security.",
            f"It's the first time {who} has travelled abroad this year;"
            f" they'll return to {there} on Friday.",
        ]
        article = " ".join(sentences[j % 4] for j in rng.permutation(8))
        out.append({"caption": f"{who} speaks with {other} in {where} on"
                               f" March {day}.",
                    "article": article})
    return out


def feature_error(got: np.ndarray, want: np.ndarray) -> float:
    """||got - want|| / ||want|| over the batch (Frobenius)."""
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


DATA_FEATURE_TOL = 0.05     # bf16 encoders against fp32, relative norm


def data_phase(torch, flash, counted, shard_dir: str):
    """Phase 18. `preprocess` of 96 jsonl records (64 train, 32 val) into
    shards of 32 on the card's ResNet-152 and RoBERTa-large (random
    weights, bf16), written into `shard_dir` (kept for phase 22), then a
    second offline pass over 256 x 256 random images; the shards read
    back; the flagship YAML trained on the shards (`nics_shards`) for 2
    epochs and evaluated (`-m best`) on the val shard. Returns the
    launches of each path and a summary (its `shards` the three paths)."""
    import tempfile

    from news_image_caption_tpu_torch import cli
    from news_image_caption_tpu_torch.config import FLAGSHIP, load_config
    from news_image_caption_tpu_torch.data import materialize as mat
    from news_image_caption_tpu_torch.data.native_loader import \
        NativeShardLoader
    from news_image_caption_tpu_torch.data.readers import NewsRecord

    flash_counted = {"flash_attention_fwd": flash.flash_attention_fwd,
                     "flash_attention_bwd": flash.flash_attention_bwd}
    all_counted = {**flash_counted, **counted}
    n_layers = FLAGSHIP["num_layers"]
    written = {}                 # shard path -> the arrays written to it
    real_write, real_encoders = mat.write_shard, mat.FeatureEncoders
    built = []

    def write(path, arrays):
        written[path] = {k: np.array(v, copy=True) for k, v in arrays.items()}
        real_write(path, arrays)

    def encoders(*args, **kw):
        built.append(real_encoders(*args, **kw))
        return built[-1]

    summary = {"card": card_line()}
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        src = f"{tmp}/news.jsonl"
        with open(src, "w") as f:
            for rec in news_records(96):
                f.write(json.dumps(rec) + "\n")
        mat.write_shard, mat.FeatureEncoders = write, encoders
        try:
            for fn in all_counted.values():
                fn.launches = 0
            t = time.perf_counter()
            rc = cli.main(["preprocess", src, f"{shard_dir}/news",
                           "--records-per-shard", "32"])
            pre_wall = time.perf_counter() - t
            check(rc == 0, f"preprocess returned {rc}")
            check(all(fn.launches == 0 for fn in all_counted.values()),
                  "preprocess launched a kernel of the port")
            paths = sorted(written)
            check([p.rsplit("/", 1)[1] for p in paths]
                  == [f"news-{i:05d}.nics" for i in range(3)],
                  f"preprocess wrote {paths}")
            enc = built[0]
            check(enc.resnet.conv1.weight.is_cuda
                  and enc.resnet.conv1.weight.dtype == torch.bfloat16
                  and enc.roberta.word_embeddings.weight.dtype
                  == torch.bfloat16, "the encoders are not bf16 on the card")
            print(f"  preprocess: 96 records, 3 shards, {pre_wall:.1f} s"
                  f" ({96 / pre_wall:.1f} records/s, the encoders' build"
                  f" included)", flush=True)

            # Real pixels: a second pass, images inline at 256 x 256.
            rng = np.random.default_rng(1)
            records = [NewsRecord(caption=r["caption"], article=r["article"],
                                  image=rng.integers(0, 256, (256, 256, 3),
                                                     dtype=np.uint8))
                       for r in news_records(32, seed=1)]
            images = np.stack([r.image for r in records])
            t = time.perf_counter()
            pix_paths = mat.materialize(None, f"{tmp}/pixels",
                                        records_per_shard=32, encoders=enc,
                                        reader=records)
            pix_wall = time.perf_counter() - t
        finally:
            mat.write_shard, mat.FeatureEncoders = real_write, real_encoders
        check(len(pix_paths) == 1, f"the pixel pass wrote {pix_paths}")

        # The encoders: bf16 on the card against the fp32 path on the
        # card, the first batch of 16 of each pass.
        r32 = copy.deepcopy(enc.resnet).float()
        b32 = copy.deepcopy(enc.roberta).float()
        fp32 = mat.FeatureEncoders(resnet=r32, resnet_state=r32.state_dict(),
                                   roberta=b32,
                                   roberta_state=b32.state_dict(),
                                   crop=enc.crop)
        errs = {}
        for what, path, imgs in (
                ("zero_images", paths[0], np.zeros((16, 256, 256, 3),
                                                   np.uint8)),
                ("pixels", pix_paths[0], images[:16])):
            arrays = written[path]
            want_img = fp32.image_patches(imgs)
            want_art = fp32.article_features(arrays["article_ids"][:16])
            check(arrays["image"].shape == (32, 49, 2048)
                  and arrays["article"].shape == (32, 512, 1024),
                  f"feature shapes {arrays['image'].shape},"
                  f" {arrays['article'].shape}")
            check(bool(np.isfinite(arrays["image"]).all()
                       and np.isfinite(arrays["article"]).all()),
                  f"{what}: non-finite features")
            errs[what] = {
                "image": feature_error(arrays["image"][:16], want_img),
                "article": feature_error(arrays["article"][:16],
                                         want_art)}
        check(feature_error(written[pix_paths[0]]["image"][:16],
                            written[paths[0]]["image"][:16]) > 0.1,
              "the pixels' features equal the zero images'")
        print(f"  encoders, bf16 on the card vs fp32 on the card, first"
              f" batch of 16: relative error (Frobenius) {errs}"
              f" (tol {DATA_FEATURE_TOL})", flush=True)
        check(all(v <= DATA_FEATURE_TOL for e in errs.values()
                  for v in e.values()),
              "the bf16 encoders' features differ from the fp32 path's")

        # Encode ms a batch of 16 (the offline pass's batch), host clock
        # of the whole call (features back on the host), and the pass's
        # records/s over the 32 pixel records.
        ids16 = written[paths[0]]["article_ids"][:16]

        def wall_ms(fn, n=5):
            fn()
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(n):
                fn()
            return (time.perf_counter() - t) / n * 1e3
        encode_ms = {"resnet_b16": wall_ms(lambda: enc.image_patches(
                         images[:16])),
                     "roberta_b16": wall_ms(lambda: enc.article_features(
                         ids16))}
        print(f"  encode a batch of 16 (host clock, features on the host):"
              f" {encode_ms}; the pixel pass: 32 records in"
              f" {pix_wall:.2f} s ({32 / pix_wall:.1f} records/s)",
              flush=True)

        # The shards read back: every field of every record bit-equal to
        # what was written; a shuffled epoch a permutation.
        for path in paths + pix_paths:
            loader = NativeShardLoader([path], batch_size=32,
                                       drop_last=False)
            (got,) = [{k: v.copy() for k, v in b.items()}
                      for b in loader.epoch(shuffle=False)]
            want = written[path]
            check(list(got) == list(want), f"{path}: fields {list(got)}")
            for k, v in want.items():
                check(got[k].dtype == v.dtype and got[k].tobytes()
                      == v.tobytes(), f"{path}: {k} read back differs")
            loader.close()
        loader = NativeShardLoader(paths, batch_size=16)
        rows = {}
        for path in paths:
            for i in range(32):
                key = written[path]["caption_ids"][i].tobytes() + \
                    written[path]["article_ids"][i].tobytes()
                rows.setdefault(key, []).append((path, i))
        seen = []
        t = time.perf_counter()
        n_batches = 0
        for batch in loader.epoch(shuffle=True, seed=3):
            n_batches += 1
            for i in range(batch["caption_ids"].shape[0]):
                seen.append(batch["caption_ids"][i].tobytes()
                            + batch["article_ids"][i].tobytes())
        read_s = time.perf_counter() - t
        loader.close()
        check(sorted(seen) == sorted(k for k, v in rows.items()
                                     for _ in v),
              "a shuffled epoch is not a permutation of the records")
        reader = {"batches_per_s": n_batches / read_s,
                  "records_per_s": len(seen) / read_s,
                  "record_bytes": sum(v[0].nbytes
                                      for v in written[paths[0]].values())}
        print(f"  shards read back bit for bit ({len(paths) + 1} shards);"
              f" a shuffled epoch of {len(seen)} records a permutation;"
              f" the reader on the host: {reader}", flush=True)

        # The flagship YAML over the shards: train 2 epochs, evaluate.
        with open(EVAL_CONFIG) as f:
            text = f.read()
        head, tail = text.split("\nmodel:", 1)
        cfg_path = f"{tmp}/flagship_shards.yaml"
        with open(cfg_path, "w") as f:
            f.write("dataset:\n  type: nics_shards\n"
                    f"  train: {{paths: [{paths[0]}, {paths[1]}]}}\n"
                    f"  val: {{paths: [{paths[2]}]}}\n"
                    f"  test: {{paths: [{paths[2]}]}}\n"
                    "model:" + tail)
        out_dir = f"{tmp}/serialization"
        ovr = json.dumps({"trainer": {
            "num_epochs": 2, "num_serialized_models_to_keep": 2,
            "log_every": 2, "optimizer": {"t_total": 100},
            "serialization_dir": out_dir}})
        cfg = load_config(cfg_path, ovr)
        B = cfg["iterator"]["batch_size"]
        steps, val_batches = 2 * (64 // B), 2 * (32 // B)
        timings = {}
        for fn in all_counted.values():
            fn.launches = 0
        t = time.perf_counter()
        rc = cli.main(["train", cfg_path, "-o", ovr], timings=timings)
        train_wall = time.perf_counter() - t
        launches["data_train"] = {n: fn.launches
                                  for n, fn in all_counted.items()}
        check(rc == 0, f"train returned {rc}")
        want = {"flash_attention_fwd": 2 * n_layers * (steps + val_batches),
                "flash_attention_bwd": 2 * n_layers * steps,
                **{n: 0 for n in counted}}
        check(launches["data_train"] == want,
              f"train launches {launches['data_train']}, expected {want}")
        with open(f"{out_dir}/metrics.jsonl") as f:
            recs = [json.loads(line) for line in f]
        train_recs = [r for r in recs if r["split"] == "train"]
        check(len(train_recs) == steps // 2
              and len(recs) == len(train_recs) + 2, f"records {recs}")
        check(all(np.isfinite(r["loss"]) for r in recs),
              "a logged loss is not finite")
        check(all(r["skipped"] == 0 for r in train_recs),
              "a train step was skipped")
        step_s = sorted(timings["step_s"])
        step_ms = step_s[len(step_s) // 2] * 1e3
        input_wait = [r["input_wait"] for r in train_recs]
        print("  train on the shards: " + "; ".join(
            f"{r['split']} step {r['step']} loss {r['loss']:.4f}"
            for r in recs), flush=True)
        print(f"  train command: {train_wall:.1f} s; step median"
              f" {step_ms:.2f} ms; input_wait {input_wait} (phase 8's"
              f" synthetic set: 0.43-0.59); flash launches"
              f" {launches['data_train']['flash_attention_fwd']} /"
              f" {launches['data_train']['flash_attention_bwd']}"
              f" ({2 * n_layers} + {2 * n_layers} a step)", flush=True)

        gcfg = cli.generation_config(cfg)
        per_step = greedy_launches_a_step()
        for fn in all_counted.values():
            fn.launches = 0
        t = time.perf_counter()
        rc = cli.main(["evaluate", cfg_path, "-o", ovr, "-m", "best",
                       "--split", "val", "--dump-attention",
                       f"{tmp}/attn"])
        eval_wall = time.perf_counter() - t
        launches["data_evaluate"] = {n: fn.launches
                                     for n, fn in all_counted.items()}
        check(rc == 0, f"evaluate returned {rc}")
        tokens = check_evaluate_files(out_dir, f"{tmp}/attn", 32 // B, gcfg,
                                      n_records=32, empty_ok=True)
        n_steps = sum(decode_steps(tk, gcfg.eos_id, gcfg.max_len)
                      for tk in tokens)
        for name, n in launches["data_evaluate"].items():
            check(n == per_step.get(name, 0) * n_steps,
                  f"evaluate: {name} launched {n} times, expected"
                  f" {per_step.get(name, 0) * n_steps}")
        print(f"  evaluate -m best on the val shard: {eval_wall:.1f} s,"
              f" {n_steps} steps, launches {launches['data_evaluate']}"
              f" (3 / 8 / 4 / 4 a step)", flush=True)
    summary.update({
        "shards": paths,
        "records": {"train": 64, "val": 32, "pixel_pass": 32},
        "preprocess_wall_s": pre_wall, "preprocess_records_per_s":
            96 / pre_wall, "pixel_pass_records_per_s": 32 / pix_wall,
        "encode_ms_b16": encode_ms, "feature_rel_err_bf16_vs_fp32": errs,
        "shard_reader": reader, "train_wall_s": train_wall,
        "train_step_ms_median": step_ms, "step_s": timings["step_s"],
        "input_wait": input_wait,
        "val_loss": [r["loss"] for r in recs if r["split"] == "val"],
        "evaluate_wall_s": eval_wall, "evaluate_steps": n_steps})
    return launches, summary


def port_phase(torch, counted):
    """Phase 19. A flagship-width Transform-and-Tell decoder
    (`tests/torch_tell_decoder.py`, seeded) saved as `best.th`, ported
    by the `port` command onto the flagship YAML, then `evaluate -m best`
    on the card. Returns the evaluate's launches and a summary."""
    import os
    import tempfile

    from news_image_caption_tpu_torch import cli
    from news_image_caption_tpu_torch.config import FLAGSHIP, load_config
    from news_image_caption_tpu_torch.models.decoder_flattened import \
        DynamicConvDecoder
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    from torch_tell_decoder import TellDecoder

    torch.manual_seed(0)
    t = time.perf_counter()
    tell = TellDecoder(**{k: FLAGSHIP[k] for k in (
        "vocab_size", "embed_dim", "ffn_dim", "num_heads", "kernel_sizes",
        "cutoff", "image_dim", "article_dim", "max_positions")}).eval()
    build_s = time.perf_counter() - t
    with tempfile.TemporaryDirectory() as tmp:
        best_th = f"{tmp}/best.th"
        torch.save({f"decoder.{k}": v for k, v in tell.state_dict().items()},
                   best_th)
        out_dir = f"{tmp}/serialization"
        t = time.perf_counter()
        rc = cli.main(["port", EVAL_CONFIG, best_th, "-s", out_dir])
        port_wall = time.perf_counter() - t
        check(rc == 0, f"port returned {rc}")
        ckpt = torch.load(f"{out_dir}/checkpoints/best.pt",
                          weights_only=True)
        master = ckpt["opt_state"]["master"]
        check(all(ckpt["params"][k].dtype == torch.bfloat16
                  and torch.equal(ckpt["params"][k], v.bfloat16())
                  for k, v in master.items()),
              "best.pt's bf16 params are not its fp32 master's")

        # Teacher-forced log-probs, fp32 on the card: the ported master
        # through the port's decoder against the reference-keyed model.
        dec = DynamicConvDecoder(**FLAGSHIP, device="cuda",
                                 dtype=torch.float32)
        dec.load_state_dict(master)
        dec.eval()
        tell = tell.cuda()
        rng = np.random.default_rng(2)
        B, T, P, S = 2, 16, 49, 64
        ids = rng.integers(3, FLAGSHIP["vocab_size"], (B, T))
        ids[:, 0] = 0
        ids[1, -3:] = 1
        ctx = {"image": torch.from_numpy(rng.standard_normal(
                   (B, P, FLAGSHIP["image_dim"])).astype(np.float32)),
               "image_mask": torch.zeros(B, P, dtype=torch.bool),
               "article": torch.from_numpy(rng.standard_normal(
                   (B, S, FLAGSHIP["article_dim"])).astype(np.float32)),
               "article_mask": torch.from_numpy(
                   np.arange(S)[None] >= np.array([[S], [40]]))}
        ctx = {k: v.cuda() for k, v in ctx.items()}
        ids_t = torch.from_numpy(ids).cuda()
        with torch.no_grad():
            got = dec.log_prob(ids_t, ctx)
            with torch.device("cuda"):
                want = tell.log_prob(ids_t, ctx)
        err = (got - want).abs().max().item()
        # The CPU tests' tolerance for teacher-forced log-probs
        # (tests/test_torch_model.py): |diff| <= 2e-4 + 2e-4 |reference|.
        excess = ((got - want).abs() - 2e-4 * want.abs()).max().item()
        print(f"  port: {port_wall:.1f} s (the reference-keyed decoder built"
              f" in {build_s:.1f} s); teacher-forced log-probs [{B}, {T},"
              f" {FLAGSHIP['vocab_size']}], fp32 on the card: max |ported -"
              f" reference-keyed| {err:.3g}, max |diff| - 2e-4 |reference|"
              f" {excess:.3g} (tol 2e-4)", flush=True)
        check(bool(torch.isfinite(got).all()), "non-finite log-probs")
        check(excess <= 2e-4, "the ported decoder's log-probs differ")
        del tell, dec, got, want

        ovr = json.dumps({"dataset": {"test": {"size": 32}},
                          "trainer": {"serialization_dir": out_dir}})
        gcfg = cli.generation_config(load_config(EVAL_CONFIG, ovr))
        for fn in counted.values():
            fn.launches = 0
        t = time.perf_counter()
        rc = cli.main(["evaluate", EVAL_CONFIG, "-o", ovr, "-m", "best",
                       "--dump-attention", f"{tmp}/attn"])
        eval_wall = time.perf_counter() - t
        launches = {n: fn.launches for n, fn in counted.items()}
        check(rc == 0, f"evaluate returned {rc}")
        tokens = check_evaluate_files(out_dir, f"{tmp}/attn", 2, gcfg,
                                      n_records=32, empty_ok=True)
    n_steps = sum(decode_steps(tk, gcfg.eos_id, gcfg.max_len)
                  for tk in tokens)
    per_step = greedy_launches_a_step()
    for name, n in launches.items():
        check(n == per_step[name] * n_steps and n > 0,
              f"evaluate: {name} launched {n} times, expected"
              f" {per_step[name] * n_steps}")
    print(f"  evaluate -m best: {eval_wall:.1f} s, {n_steps} steps,"
          f" launches {launches} (3 / 8 / 4 / 4 a step)", flush=True)
    return launches, {"port_wall_s": port_wall, "tell_build_s": build_s,
                      "log_prob_max_abs_diff": err,
                      "log_prob_excess_over_rtol": excess,
                      "evaluate_wall_s": eval_wall,
                      "evaluate_steps": n_steps, "card": card_line()}


DETECT_CONFIG = "configs/nytimes/transformer_faces.yaml"
# The phase's photo (numpy seed 20) and MTCNN weights (drawn on the CPU
# from a generator seeded with 0), with the face-class biases of PNet's
# conv4_1, RNet's dense5_1 and ONet's dense6_1 raised by these: on the
# CPU, 283 of 50114 PNet cells, 11 of 281 RNet crops and 5 of 8 ONet
# crops pass, 4 faces, every probability at least 7.2e-5 from its
# threshold (`tests/test_torch_detection.py` raises them the same way).
DETECT_FACE_BIAS = (0.1, 0.4, 0.7)
DETECT_PHOTO = (480, 640, 3)
# A detector net's outputs on the card (fp32, TF32 off) against its CPU
# copy on the same inputs: max |card - CPU| <= DETECT_NET_TOL * max(1,
# max |CPU|).
DETECT_NET_TOL = 1e-4


def cascade_states(torch) -> list:
    """PNet, RNet and ONet state dicts drawn on the CPU, face biases
    raised by DETECT_FACE_BIAS."""
    from news_image_caption_tpu_torch.models import facenet
    g = torch.Generator().manual_seed(0)
    out = []
    for cls, head, bias in zip((facenet.PNet, facenet.RNet, facenet.ONet),
                               ("conv4_1", "dense5_1", "dense6_1"),
                               DETECT_FACE_BIAS):
        sd = cls(device="cpu", generator=g).state_dict()
        sd[f"{head}.bias"][1] += bias
        out.append(sd)
    return out


def net_vs_cpu(torch, net, x: np.ndarray, what: str) -> float:
    """`net`'s outputs on the card against its CPU copy on the same NCHW
    float32 input, both fp32 without TF32: max |diff| over max(1, max
    |CPU|), held to DETECT_NET_TOL."""
    from news_image_caption_tpu_torch.models.facenet import fp32_exact
    cpu = copy.deepcopy(net).to("cpu")
    xt = torch.from_numpy(np.ascontiguousarray(x))
    with torch.inference_mode(), fp32_exact():
        got, want = net(xt.cuda()), cpu(xt)
    flat = []

    def walk(g, w):
        if isinstance(w, torch.Tensor):
            flat.append((g.float().cpu(), w.float()))
        else:
            for a, b in zip(g, w):
                walk(a, b)

    walk(got, want)
    err = max((g - w).abs().max().item() / max(1.0, w.abs().max().item())
              for g, w in flat)
    print(f"  {what} {tuple(x.shape)}: card vs CPU (fp32, TF32 off), max"
          f" |diff| / max(1, max |CPU|) {err:.3g} (tol {DETECT_NET_TOL})",
          flush=True)
    check(err <= DETECT_NET_TOL, f"{what}: the card's outputs differ from"
          " the CPU's")
    return err


def cascade_counts(mtcnn, image: np.ndarray):
    """(boxes, [(net, boxes above its threshold, boxes in)] of each net
    call) of `mtcnn.detect(image)`."""
    seen = []
    run = mtcnn._run

    def counting(net, batch):
        out = run(net, batch)
        probs = out[0][:, 1].ravel()
        name = type(net).__name__
        thr = mtcnn.thresholds[("PNet", "RNet", "ONet").index(name)]
        seen.append((name, int((probs > thr).sum()), int(probs.size)))
        return out

    mtcnn._run = counting
    try:
        boxes, _ = mtcnn.detect(image)
    finally:
        mtcnn._run = run
    return boxes, seen


def detect_caption_phase(torch, counted):
    """Phase 20. `serving/worker.py::full_model_builder` on the card at
    full width: the faces captioner of DETECT_CONFIG in bf16 from seeded
    random weights, MTCNN (forced detections), InceptionResnetV1 and
    YOLOv3-SPP at 256 from `full_model_builder`'s seeded weights, on a
    480 x 640 photo with the flagship's precomputed image and article
    features. Returns (launches, summary)."""
    import functools
    import statistics

    from news_image_caption_tpu_torch import cli
    from news_image_caption_tpu_torch.config import build_model, load_config
    from news_image_caption_tpu_torch.models import facenet
    from news_image_caption_tpu_torch.models.variants import nan_to_mask
    from news_image_caption_tpu_torch.models.yolov3 import (
        ObjectFeatureExtractor, letterbox)
    from news_image_caption_tpu_torch.serving.worker import \
        full_model_builder

    cfg = load_config(DETECT_CONFIG)
    model = build_model(cfg, "cuda", torch.bfloat16,
                        torch.Generator(device="cuda").manual_seed(0))
    model.param_module.eval()
    states = cascade_states(torch)
    real_mtcnn = facenet.MTCNN
    facenet.MTCNN = functools.partial(real_mtcnn, *states)
    try:
        t = time.perf_counter()
        predict = full_model_builder(caption_model=model, device="cuda")
        build_s = time.perf_counter() - t
    finally:
        facenet.MTCNN = real_mtcnn
    t = time.perf_counter()
    predict.warmup()
    warmup_s = time.perf_counter() - t
    gcfg = dataclasses.replace(cli.generation_config(cfg), max_len=32)
    rng = np.random.RandomState(20)
    job = make_job(rng, 1, [400])
    job["image_raw"] = np.random.default_rng(20).integers(
        0, 256, DETECT_PHOTO, np.uint8)
    photo = job["image_raw"]
    mtcnn, embedder, objector = (predict.mtcnn, predict.embedder,
                                 predict.objector)
    t = time.perf_counter()
    predict(job)                            # cuDNN's first calls
    first_s = time.perf_counter() - t

    # Each net against its CPU copy on identical inputs.
    errs = {}
    H, W = photo.shape[:2]
    scale = 12.0 / mtcnn.min_face
    pyr = mtcnn._norm(mtcnn._resize(photo, int(H * scale), int(W * scale)))
    errs["pnet"] = net_vs_cpu(torch, mtcnn.pnet,
                              pyr[None].transpose(0, 3, 1, 2), "PNet")
    crops = np.random.default_rng(21).uniform(-1, 1, (16, 3, 48, 48)
                                              ).astype(np.float32)
    errs["rnet"] = net_vs_cpu(torch, mtcnn.rnet, crops[:, :, :24, :24],
                              "RNet")
    errs["onet"] = net_vs_cpu(torch, mtcnn.onet, crops, "ONet")
    boxes, seen = cascade_counts(mtcnn, photo)
    faces = mtcnn.extract_faces(photo, boxes[:4])
    check(len(faces) >= 1, "phase 20: MTCNN found no face")
    errs["embedder"] = net_vs_cpu(torch, embedder,
                                  faces.transpose(0, 3, 1, 2),
                                  "InceptionResnetV1")
    boxed, _, _ = letterbox(photo, objector.img_size)
    errs["yolo_256"] = net_vs_cpu(
        torch, objector.model,
        (boxed.astype(np.float32)[None] / 255.0).transpose(0, 3, 1, 2),
        "YoloV3SPP")
    cpu_mtcnn = facenet.MTCNN(*states, device="cpu")
    cpu_boxes, cpu_seen = cascade_counts(cpu_mtcnn, photo)
    box_err = (float(np.abs(boxes - cpu_boxes).max())
               if boxes.shape == cpu_boxes.shape and len(boxes) else None)
    print(f"  MTCNN on the {H} x {W} photo: {len(boxes)} faces; each net"
          f" call's (net, passed, in): {seen}; the CPU's: {cpu_seen}; max"
          f" |box diff| {box_err}", flush=True)
    check(seen == cpu_seen and box_err is not None and box_err <= 1e-2,
          "phase 20: the cascade's counts or boxes differ from the CPU's")

    # predict against the model's own generate on the batch built by
    # hand from the detectors' outputs, the launches, the maps.
    (out, launches, predict_s) = counted_run(counted, lambda: predict(job))
    emb = facenet.embed_faces(embedder, faces)
    slots = np.full((4, 512), np.nan, np.float32)
    slots[:len(emb)] = emb
    batch = stage_batch(torch, {k: job[k] for k in (
        "image", "image_mask", "article", "article_mask")}, "cuda")
    f, fm = nan_to_mask(torch.from_numpy(slots)[None])
    batch["faces"], batch["faces_mask"] = f.cuda().bfloat16(), fm.cuda()
    w = model.decode_weights()
    (tokens, _), gen_ms = events_ms(torch, lambda: model.generate(
        batch, gcfg, w))
    tok = tokens.to(torch.int32).cpu().numpy()
    check(np.array_equal(out["tokens"], tok), "phase 20: predict's tokens"
          " differ from generate's on the detectors' faces")
    check_tokens(tok, 1, gcfg, cfg["model"]["vocab_size"])
    check(int(out["n_faces"]) == len(faces), "phase 20: n_faces")
    check(out["obj_boxes"].shape == (int(out["n_objects"]), 4),
          "phase 20: obj_boxes")
    steps = decode_steps(tok, gcfg.eos_id, gcfg.max_len)
    check_launches(DETECT_CONFIG, launches, greedy_launches_a_step(3), steps)
    T = tok.shape[1] - 1
    for li in range(len(model.decoder.layers)):
        for name, n in (("image", 49), ("article", 512), ("faces", 4)):
            attn = out[f"attn_l{li}_{name}"]
            check(attn.shape == (1, T, n + 2) and bool(np.isfinite(
                attn).all()) and bool(np.allclose(attn.sum(-1), 1.0,
                                                  atol=1e-2)),
                  f"phase 20: attn_l{li}_{name} {attn.shape}")
    _, maps_ms = events_ms(torch, lambda: model.attention_maps(
        batch, tokens[:, :-1]))
    summary = {"config": DETECT_CONFIG, "build_s": build_s,
               "warmup_s": warmup_s, "first_predict_s": first_s,
               "n_faces": int(out["n_faces"]),
               "n_objects": int(out["n_objects"]), "steps": steps,
               "cascade": seen, "net_vs_cpu": errs,
               "box_max_abs_diff_vs_cpu": box_err,
               "counted_predict_s": predict_s,
               **captioner_vs_plain(torch, model, batch, w, DETECT_CONFIG)}

    # Readings: the stages on the host clock, the nets by CUDA events.
    mtcnn.timings, objector.timings = {}, {}
    walls = []
    for _ in range(10):
        t = time.perf_counter()
        predict(job)
        walls.append((time.perf_counter() - t) * 1e3)
    stage_ms = {f"mtcnn_{k}": v * 1e3 for k, v in mtcnn.timings.items()}
    stage_ms.update({f"yolo_{k}": v * 1e3
                     for k, v in objector.timings.items()})
    mtcnn.timings = objector.timings = None
    _, embed_ms = events_ms(torch, lambda: facenet.embed_faces(embedder,
                                                               faces))
    _, yolo_ms = events_ms(torch, lambda: objector.forward(boxed))
    wall, busy, _ = profiled_busy(torch, lambda: predict(job))
    ex416 = ObjectFeatureExtractor(objector.model.state_dict(), 416,
                                   device="cuda")
    ex416(photo)
    (b416, f416), ex416_ms = events_ms(torch, lambda: ex416(photo))
    check(b416.shape == (len(f416), 4) and f416.shape[1:] == (1024,)
          and bool(np.isfinite(f416).all()), "phase 20: objects at 416")
    boxed416, _, _ = letterbox(photo, 416)
    _, yolo416_ms = events_ms(torch, lambda: ex416.forward(boxed416))
    walls.sort()
    summary.update({
        "predict_ms": {"calls": len(walls), "median": statistics.median(
            walls), "min": walls[0], "max": walls[-1]},
        "last_call_ms": stage_ms, "embed_ms": embed_ms,
        "yolo_256_forward_ms": yolo_ms, "generate_ms": gen_ms,
        "maps_ms": maps_ms, "profiled_predict": {
            "wall_ms": wall, "device_busy_ms": busy,
            "device_busy_share": busy / wall},
        "objects_416": {"n": len(f416), "call_ms": ex416_ms,
                        "forward_ms": yolo416_ms},
        "launches": launches, "card": card_line()})
    print(f"  predict: median {summary['predict_ms']['median']:.1f} ms over"
          f" 10 calls; last call's stages (host ms) {stage_ms}; embed"
          f" {embed_ms:.2f} ms, YOLO at 256 {yolo_ms:.2f} ms, at 416"
          f" {yolo416_ms:.2f} ms, generate {gen_ms:.1f} ms ({steps} steps),"
          f" maps {maps_ms:.1f} ms (CUDA events); device busy {busy:.1f} of"
          f" {wall:.1f} ms", flush=True)
    del predict, model, ex416
    torch.cuda.empty_cache()
    return launches, summary


# -- phase 21: int8 context K/V and int8 head tables ----------------------

# The routes' switches, and the bf16 kernel each int8 variant stands in
# for: under its switch the bf16 kernel must not launch at all.
QUANT_SWITCHES = {"kv": (True, False), "head": (False, True),
                  "both": (True, True)}
INT8_OF = {"band_topk_lse_int8": "band_topk_lse",
           "decode_cross_attention_int8": "decode_cross_attention"}


def quant_kernel_phase(torch, ops):
    """Phase 21.1. `decode_cross_attention_int8` (kernel A) and
    `band_topk_lse_int8` (kernel B) against their plain twins on the card
    at the flagship's shapes, the K/V and tables quantized from seeded
    bf16 ones by the port's own quantizers; second calls bit-equal; timed
    with their plain twins, the library chains and the bound. Returns
    three {kernel: result}: a greedy step at B=16, a beam-5 step at B=16
    and (kernel A) a speculative chunk of 4 at B=16, all layers."""
    from news_image_caption_tpu_torch.ops.adaptive import \
        quantize_embed_tables
    from news_image_caption_tpu_torch.ops.attention import (AttentionKV,
                                                            quantize_kv)
    band, xattn = ops
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    bf16 = torch.bfloat16

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(bf16)

    N, D, H = 16, 1024, 16
    NB = 5 * N
    names = ("band_topk_lse_int8", "decode_cross_attention_int8")
    greedy = {n: Tally() for n in names}
    beam = {n: Tally() for n in names}
    chunk = {"decode_cross_attention_int8": Tally()}

    # Kernel B over the three word tables (the int8 head band is table0
    # alone, every id selectable; the class rows stay exact outside it),
    # at 1, 16, 80 and 640 rows. Tolerances as phase 3's: one bf16
    # rounding of a logit (0.03125) for the values and for the plain
    # logit at each id the kernel chose, 1e-3 + 1e-4 |lse| for the lse.
    # Library chain: (x @ q.to(bf16).T) * scale, logsumexp, topk.
    for V in (5000, 15000, 30265):
        ((qt, _),) = quantize_embed_tables([(rn(V, D, scale=D ** -0.5),
                                             None)])
        for n, k, tally in ((1, 1, None), (N, 1, greedy), (NB, 5, beam),
                            (5 * 128, 5, None)):
            x = rn(n, D)
            got = band.band_topk_lse_int8(x, qt.q, qt.scale, k)
            again = band.band_topk_lse_int8(x, qt.q, qt.scale, k)
            want = band.band_topk_lse_int8_plain(x, qt.q, qt.scale, k)
            torch.cuda.synchronize()
            logits = ((x.float() @ qt.q.float().T) * qt.scale.float()).to(
                bf16).float()
            e_v, ok_v = within(got[0], want[0], 0.03125, 0.0)
            e_l, ok_l = within(got[2], want[2], 1e-3, 1e-4)
            e_i, ok_i = within(torch.gather(logits, 1, got[1].long()),
                               want[0], 0.03125, 0.0)
            agree = (got[1] == want[1]).float().mean().item()
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            print(f"  band_topk_lse_int8 V={V} N={n} k={k}: values {e_v:.3g},"
                  f" lse {e_l:.3g}, plain logit at chosen ids {e_i:.3g} (tol"
                  f" 0.03125 / 1e-3+1e-4|lse| / 0.03125), ids equal"
                  f" {agree:.3f}, repeated call bit-equal {same}", flush=True)
            check(ok_v and ok_l and ok_i and bool((got[1] >= 0).all())
                  and bool((got[1] < V).all()),
                  f"band_topk_lse_int8 V={V} N={n} k={k} disagrees with its"
                  " plain twin")
            check(same, f"band_topk_lse_int8 V={V} N={n} k={k}: two calls on"
                  " the same inputs differ")
            if tally is None:
                continue
            tally["band_topk_lse_int8"].errs += [e_v, e_l]

            def library(x=x, k=k):
                lg = (x @ qt.q.to(bf16).T) * qt.scale
                return torch.logsumexp(lg.float(), -1), torch.topk(lg, k)
            line = tally["band_topk_lse_int8"].add(
                (x, qt.q, qt.scale, *got), 2.0 * n * V * D,
                time_ms(lambda: band.band_topk_lse_int8(x, qt.q, qt.scale,
                                                        k)),
                time_ms(lambda: band.band_topk_lse_int8_plain(
                    x, qt.q, qt.scale, k)),
                time_ms(library))
            print(f"    time N={n} k={k}: {line}")

    # Kernel A over the article (S' = 514) and image (S' = 51) contexts,
    # half the items' keys padded; tolerance 0.02 abs + 0.02 rel, one bf16
    # rounding of a probability or of the output (phase 3's). The timed
    # shapes, 4 layers each: a greedy step (Q = 1), a beam-5 step (Q = 5)
    # and a speculative chunk of 4 (Q = 4), all at B=16. Library chain:
    # the int8 K and V widened and scaled, then scaled_dot_product_attention.
    dh = D // H

    def acase(B, Q, S, tally=None, one_key=False):
        bias = torch.zeros(B, S, device=dev)
        bias[B // 2:, S // 2:S - 2] = -1e9
        if one_key:
            bias[0] = -1e9
            bias[0, S // 3] = 0.0
        kv = quantize_kv(AttentionKV(rn(B, S, D), rn(B, S, D), bias), H)
        q = rn(B, Q, D, scale=0.125)
        args = (q, kv.k_q, kv.k_scale, kv.v_q, kv.v_scale, kv.bias, H)
        got = xattn.decode_cross_attention_int8(*args)
        again = xattn.decode_cross_attention_int8(*args)
        want = xattn.decode_cross_attention_int8_plain(*args)
        torch.cuda.synchronize()
        e, ok = within(got, want, 0.02, 0.02)
        same = bool(torch.equal(got, again))
        what = f"B={B} Q={Q} S'={S}" + (" (item 0: one key)" if one_key
                                        else "")
        print(f"  decode_cross_attention_int8 {what}: {e:.3g} (tol 0.02 +"
              f" 0.02|ref|), repeated call bit-equal {same}", flush=True)
        check(ok, f"decode_cross_attention_int8 {what} disagrees")
        check(same, f"decode_cross_attention_int8 {what}: two calls on the"
              " same inputs differ")
        if tally is None:
            return
        tally.errs.append(e)

        def widened(t, scale):
            return (t.to(bf16).view(B, S, H, dh) * scale[..., None]).view(
                B, S, D)

        def library():
            return sdpa(torch, q, widened(kv.k_q, kv.k_scale),
                        widened(kv.v_q, kv.v_scale), kv.bias, H)
        line = tally.add(
            (*args[:6], got), 4.0 * B * Q * S * D,
            time_ms(lambda: xattn.decode_cross_attention_int8(*args)),
            time_ms(lambda: xattn.decode_cross_attention_int8_plain(*args)),
            time_ms(library), calls=4)
        print(f"    time {what}, 4 layers: {line}")

    for S in (514, 51):
        acase(N, 1, S, greedy["decode_cross_attention_int8"])
        acase(N, 5, S, beam["decode_cross_attention_int8"])
        acase(N, 4, S, chunk["decode_cross_attention_int8"])
        acase(128, 5, S)
        acase(1, 1, S)
        acase(1, 16, S)
    for S in (1, 63, 65):
        acase(N, 1, S)
    acase(N, 5, 514, one_key=True)
    return tuple({n: t.result() for n, t in d.items()}
                 for d in (greedy, beam, chunk))


def quant_launches(per_step: dict, switch: str) -> dict:
    """per_step of the exact route moved onto the int8 variants that
    `switch` turns on: {kernel: launches a step} over the six kernels."""
    qk, qh = QUANT_SWITCHES[switch]
    out = dict(per_step, band_topk_lse_int8=0, decode_cross_attention_int8=0)
    for on, k8 in ((qh, "band_topk_lse_int8"),
                   (qk, "decode_cross_attention_int8")):
        if on:
            out[k8], out[INT8_OF[k8]] = out[INT8_OF[k8]], 0
    return out


def quant_decode_phase(torch, counted):
    """Phases 21.2 to 21.5 on phase 4's flagship weights (seed 0, bf16),
    built by `flagship_model_builder(quantize_kv=True,
    quantize_head=True)`: greedy and beam-5 at B=16 under each switch
    (tokens against the exact route's), speculative greedy under each
    (tokens equal to that switch's greedy), the greedy and beam pools
    under both (each request its row of the same path at the pool's row
    count). Returns (the builder's predict, the B=16 job, {path:
    launches}, summary)."""
    from news_image_caption_tpu_torch.config import FLAGSHIP
    from news_image_caption_tpu_torch.generation.continuous import (
        ContinuousBatcher, ContinuousBeamBatcher)
    from news_image_caption_tpu_torch.generation.generator import \
        GenerationConfig
    from news_image_caption_tpu_torch.serving.worker import \
        flagship_model_builder

    t0 = time.perf_counter()
    qpredict = flagship_model_builder("cuda", batch_size=1, max_len=32,
                                      early_exit=True, seed=0,
                                      quantize_kv=True, quantize_head=True)
    qpredict.warmup()
    model, weights = qpredict.model, qpredict.weights
    check(weights.quant_tables is not None, "the builder did not quantize"
          " the head tables at load")
    print(f"  flagship_model_builder(quantize_kv=True, quantize_head=True):"
          f" built and warmed up in {time.perf_counter() - t0:.1f} s",
          flush=True)
    V, K = FLAGSHIP["vocab_size"], 5
    rng = np.random.RandomState(21)
    job16 = make_job(rng, 16, rng.randint(20, 513, size=16))
    batch16 = stage_batch(torch, job16, "cuda")
    launches, summary = {}, {}

    def cfg_of(switch=None, **kw):
        qk, qh = QUANT_SWITCHES[switch] if switch else (False, False)
        return GenerationConfig(max_len=32, early_exit=True, quantize_kv=qk,
                                quantize_head=qh, **kw)

    # 21.2 / 21.3 greedy and beam-5 at B=16: each switch against the
    # exact route (the share of equal tokens, a reading), launches from
    # the counts zeroed just before each run.
    exact_g = model.generate(batch16, cfg_of(), weights)[0].cpu().numpy()
    exact_b = model.generate_beam(batch16, cfg_of(beam_size=K),
                                  weights)[0].cpu().numpy()
    greedy_tokens = {}
    for switch in QUANT_SWITCHES:
        cfg = cfg_of(switch)
        (tok, lp), n, secs = counted_run(
            counted, lambda: model.generate(batch16, cfg, weights))
        tok = tok.cpu().numpy()
        check_tokens(tok, 16, cfg, V)
        check(bool(torch.isfinite(lp).all()), f"greedy ({switch}):"
              " non-finite log-probs")
        steps = decode_steps(tok, cfg.eos_id, cfg.max_len)
        check_launches(f"greedy B=16 ({switch})", n,
                       quant_launches(greedy_launches_a_step(), switch),
                       steps)
        launches[f"quant_greedy_{switch}"] = n
        greedy_tokens[switch] = tok
        eq = float((tok[:, 1:] == exact_g[:, 1:]).mean())
        bcfg = cfg_of(switch, beam_size=K)
        (btok, bsc), bn, bsecs = counted_run(
            counted, lambda: model.generate_beam(batch16, bcfg, weights))
        btok, bsc = btok.cpu().numpy(), bsc.cpu().numpy()
        check_beams(btok, bsc, 16, bcfg, V)
        bsteps = decode_steps(btok.reshape(-1, btok.shape[-1]), bcfg.eos_id,
                              bcfg.max_len)
        check_launches(f"beam-5 B=16 ({switch})", bn,
                       quant_launches(beam_launches_a_step(torch, 16 * K, K),
                                      switch), bsteps)
        launches[f"quant_beam5_{switch}"] = bn
        beq = float((btok[:, :, 1:] == exact_b[:, :, 1:]).mean())
        beq0 = float((btok[:, 0, 1:] == exact_b[:, 0, 1:]).mean())
        summary[switch] = {"greedy_equal_to_exact": eq,
                           "greedy_wall_s": secs, "greedy_steps": steps,
                           "beam5_equal_to_exact": beq,
                           "beam5_best_equal_to_exact": beq0,
                           "beam5_wall_s": bsecs, "beam5_steps": bsteps}
        print(f"  {switch}: greedy B=16 tokens equal to the exact route's"
              f" {eq:.3f} ({steps} steps, {secs:.2f} s); beam-5 B=16"
              f" {beq:.3f}, best beam {beq0:.3f} ({bsteps} steps,"
              f" {bsecs:.2f} s)", flush=True)

    # 21.4 speculative greedy, spec_k 4, oracle drafts (the switch's own
    # greedy caption): the tokens of that greedy, all of them. A chunk of
    # 4 at B=16: 3 / 8 / 16 / 16 launches (phase 11.5), moved onto the
    # int8 variants the switch turns on.
    spec_per_chunk = {"band_topk_lse": 3, "decode_cross_attention": 8,
                      "decode_conv_block": 16, "decode_ffn_block": 16}
    for switch, want in greedy_tokens.items():
        cfg = cfg_of(switch)
        src = torch.from_numpy(want[:, 1:]).to(batch16["image"].device)
        (toks, _, chunks), n, secs = counted_run(
            counted, lambda: model.generate_speculative(
                dict(batch16, article_ids=src), cfg, weights, spec_k=4))
        check_launches(f"speculative ({switch})", n,
                       quant_launches(spec_per_chunk, switch), chunks)
        launches[f"quant_speculative_{switch}"] = n
        eq = float((toks.cpu().numpy() == want).mean())
        summary[switch].update(speculative_equal_to_greedy=eq,
                               speculative_chunks=chunks,
                               speculative_wall_s=secs)
        print(f"  {switch}: speculative B=16, spec_k 4, oracle drafts:"
              f" {chunks} chunks, tokens equal to the quantized greedy's"
              f" {eq:.4f} (must be 1)", flush=True)
        check(eq == 1.0, f"speculative ({switch}) differs from the"
              " quantized greedy")

    # 21.5 the greedy pool (16 slots, 16 requests, caps 8 to 32) and the
    # beam pool (8 slots of 5 rows, 8 requests) under both switches: each
    # request its row of the same path at the pool's row count.
    cfg, bcfg = cfg_of("both"), cfg_of("both", beam_size=K)
    jobs = [make_job(rng, 1, [n]) for n in rng.randint(20, 513, size=16)]
    batches = [stage_batch(torch, j, "cuda") for j in jobs]
    caps = rng.randint(8, 33, size=16)
    engine = ContinuousBatcher.for_flattened(model, cfg, 16, weights=weights,
                                             inner_steps=8)
    (ids, res), n, secs = counted_run(counted, lambda: (
        [engine.submit(b, max_len=int(c)) for b, c in zip(batches, caps)],
        engine.run()))
    steps = engine.n_chunks * engine.inner_steps
    check_launches("greedy pool (both)", n,
                   quant_launches(greedy_launches_a_step(), "both"), steps)
    launches["quant_greedy_pool"] = n
    want, _ = rows_generate(torch, model, weights, batches, cfg)
    want = want.cpu().numpy()
    for r in range(16):
        exp = want[r].copy()
        exp[caps[r] + 1:] = cfg.pad_id
        check(bool(np.array_equal(res[ids[r]][0], exp)),
              f"greedy pool (both): request {r} differs from its row of the"
              " quantized generate at B=16")
    del engine
    engine = ContinuousBeamBatcher(model, bcfg, 8, weights=weights,
                                   inner_steps=8)
    (bids, bres), bn, bsecs = counted_run(counted, lambda: (
        [engine.submit(b) for b in batches[:8]], engine.run()))
    bsteps = engine.n_chunks * engine.inner_steps
    check_launches("beam pool (both)", bn,
                   quant_launches(beam_launches_a_step(torch, 40, K), "both"),
                   bsteps)
    launches["quant_beam_pool"] = bn
    want_t, want_s = rows_generate_beam(torch, model, weights, batches[:8],
                                        bcfg)
    for r in range(8):
        got_t, got_s = bres[bids[r]]
        check(bool(np.array_equal(got_t, want_t[r].cpu().numpy()))
              and bool(np.array_equal(got_s, want_s[r].cpu().numpy())),
              f"beam pool (both): request {r} differs from its row of the"
              " quantized generate_beam at B=8")
    del engine
    summary["pools"] = {"greedy_requests": 16, "greedy_wall_s": secs,
                        "beam_requests": 8, "beam_wall_s": bsecs}
    print(f"  pools (both): 16 greedy requests and 8 beam-5 requests equal to"
          f" their rows of the quantized generate / generate_beam; {secs:.2f}"
          f" / {bsecs:.2f} s", flush=True)
    return qpredict, job16, launches, summary


def quant_serve_phase(torch, qpredict, job16):
    """Phase 21.6: returns (the worker's launches, summary)."""
    from news_image_caption_tpu_torch.serving.client import CaptioningClient

    rng = np.random.RandomState(22)
    # 21.6 `serve --quantize-kv --quantize-head` (one worker on the card,
    # the same seeded weights): three B=1 jobs and the B=16 job through
    # the client, each equal to this process's builder's tokens; the
    # worker's launches from its stats RPC, int8 variants only.
    sjobs = [make_job(rng, 1, [n]) for n in (512, 300, 40)] + [job16]
    local = [qpredict(j)["tokens"] for j in sjobs]
    t0 = time.perf_counter()
    with ServeProcess(SERVE_CMD + ["--quantize-kv",
                                   "--quantize-head"]) as serve:
        info = json.loads(serve.next_line("stdout", 120))
        serve.next_line("stdout", 60)                    # the http port
        serve.next_line("stderr", 300, match="worker 0 ready")
        ready_s = time.perf_counter() - t0
        client = CaptioningClient(info["frontend_addr"],
                                  info["sink_pub_addr"], timeout_ms=300000)
        try:
            stats0 = client.stats(timeout_ms=60000)
            lat = []
            for i, job in enumerate(sjobs):
                t = time.perf_counter()
                got = client.caption(job)["tokens"]
                lat.append((time.perf_counter() - t) * 1e3)
                check(bool(np.array_equal(got, local[i])),
                      f"serve --quantize-kv --quantize-head: job {i} differs"
                      " from the in-process builder's")
            stats = client.stats(timeout_ms=60000)
        finally:
            client.close()
        rc, _ = serve.stop()
        check(rc == 0, f"serve --quantize-kv --quantize-head exited with {rc}")
        left = [p for p in serve.children if _alive(p)]
        check(not left, f"processes left after serve stopped: {left}")
    steps = sum(decode_steps(t, 2, 32) for t in local)
    per_step = quant_launches(greedy_launches_a_step(), "both")
    n = {k: stats["kernel_launches"][k] - stats0["kernel_launches"][k]
         for k in per_step}
    check_launches("serve --quantize-kv --quantize-head (worker)", n,
                   per_step, steps)
    print(f"  serve --quantize-kv --quantize-head: 4 jobs equal to the"
          f" in-process builder's, request ms {[round(x, 1) for x in lat]};"
          f" start to ready {ready_s:.1f} s", flush=True)
    return n, {"start_to_ready_s": ready_s, "request_ms": lat,
               "steps": steps}


def quant_evaluate_phase(torch, counted):
    """Phase 21.7: returns (the command's launches, summary)."""
    import tempfile

    from news_image_caption_tpu_torch import cli
    from news_image_caption_tpu_torch.config import (build_dataset,
                                                     load_config)

    # 21.7 evaluate with generation.quantize_kv on phase 7's 256 records:
    # the files, launches (the int8 attention 8 a step, the bf16 one
    # none), the first batch the rebuilt model's quantized generate, and
    # its share of tokens equal to the exact route's.
    with tempfile.TemporaryDirectory() as tmp:
        out_dir, attn_dir = f"{tmp}/serialization", f"{tmp}/attn"
        overrides = json.dumps({"trainer": {"serialization_dir": out_dir},
                                "generation": {"quantize_kv": True}})
        ecfg = load_config(EVAL_CONFIG, overrides)
        gcfg = cli.generation_config(ecfg)
        check(gcfg.quantize_kv and not gcfg.quantize_head,
              f"evaluate's generation config {gcfg}")
        rc, n, wall = counted_run(counted, lambda: cli.main(
            ["evaluate", EVAL_CONFIG, "--split", "test", "--dump-attention",
             attn_dir, "-o", overrides]))
        check(rc == 0, f"evaluate with quantize_kv returned {rc}")
        tokens = check_evaluate_files(out_dir, attn_dir, 16, gcfg)
    steps = sum(decode_steps(t, gcfg.eos_id, gcfg.max_len) for t in tokens)
    check_launches("evaluate (quantize_kv)", n,
                   quant_launches(greedy_launches_a_step(), "kv"), steps)
    emodel = cli.evaluation_model(ecfg, torch.device("cuda"))
    eweights = emodel.decoder.decode_weights()
    batch_np = next(build_dataset(ecfg, "test").batches(16, shuffle=False))
    batch = {k: torch.from_numpy(batch_np[k]).cuda()
             for k in ("image", "image_mask", "article", "article_mask")}
    tok_q = emodel.generate(batch, gcfg, eweights)[0].to(torch.int32)
    check(bool(np.array_equal(tok_q.cpu().numpy(), tokens[0])),
          "evaluate (quantize_kv): the rebuilt model's first batch differs"
          " from the command's")
    exact = dataclasses.replace(gcfg, quantize_kv=False)
    tok_e = emodel.generate(batch, exact, eweights)[0].cpu().numpy()
    eq = float((tokens[0][:, 1:] == tok_e[:, 1:]).mean())
    print(f"  evaluate (quantize_kv): {wall:.1f} s, {256 / wall:.2f}"
          f" captions/s, {steps} steps; first batch tokens equal to the"
          f" exact route's {eq:.3f}", flush=True)
    return n, {"wall_s": wall, "captions_per_s": 256 / wall,
               "decode_steps": steps, "first_batch_equal_to_exact": eq}


def quantize_phase(torch, counted):
    """Phases 21.2 to 21.7 (see `quant_decode_phase`,
    `quant_serve_phase`, `quant_evaluate_phase`). `counted` holds the six
    kernels. Returns ({path: launches}, summary)."""
    qpredict, job16, launches, summary = quant_decode_phase(torch, counted)
    launches["quant_serve"], summary["serve"] = quant_serve_phase(
        torch, qpredict, job16)
    del qpredict
    launches["quant_evaluate"], summary["evaluate"] = quant_evaluate_phase(
        torch, counted)
    summary["card"] = card_line()
    return launches, summary


PROFILE_WINDOW = {"profile_start": 2, "profile_steps": 3}


def trace_counts(path: str) -> dict:
    """In a `torch.profiler` trace file: the device events of the port's
    flash kernels, all device kernels, and the train step's
    `record_function` spans (their host side)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    spans = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    return {"flash_fwd_kernel": sum("flash_fwd_kernel" in k
                                    for k in kernels),
            "flash_bwd_kernel": sum("flash_bwd_kernel" in k
                                    for k in kernels),
            "device_kernels": len(kernels),
            **{s: spans.count(s) for s in (
                "train_step.forward", "train_step.backward",
                "train_step.optimizer")}}


def profile_window_phase(torch, flash_counted):
    """Phase 22.1. The train command on the flagship YAML (full width and
    depth, bf16_o2, flash) with `trainer.profile_start: 2,
    profile_steps: 3`: 80 train records (5 steps an epoch), one epoch,
    then `-r` with two epochs, resuming at step 5, past the start. Each
    run must write one trace into `<serialization_dir>/profile` holding
    3 steps' flash kernels (8 forward and 8 backward a step) and 3
    `train_step.forward` spans, the second window opening at step 5.
    Returns the flash launches of both runs and a summary."""
    import glob
    import logging
    import os
    import tempfile

    from news_image_caption_tpu_torch import cli
    from news_image_caption_tpu_torch.config import FLAGSHIP

    per_step = 2 * FLAGSHIP["num_layers"]
    steps = PROFILE_WINDOW["profile_steps"]
    messages = []
    handler = logging.Handler()
    handler.emit = lambda record: messages.append(record.getMessage())
    logging.getLogger("trainer").addHandler(handler)
    launches = dict.fromkeys(flash_counted, 0)
    summary = {"window": PROFILE_WINDOW, "traces": [], "card": card_line()}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            out_dir = f"{tmp}/serialization"
            for epochs, extra in ((1, []), (2, ["-r"])):
                ovr = json.dumps({
                    "dataset": {"train": {"size": 80}, "val": {"size": 16},
                                "test": {"size": 16}},
                    "trainer": {"num_epochs": epochs, **PROFILE_WINDOW,
                                "num_serialized_models_to_keep": 1,
                                "log_every": 5, "summary_interval": 0,
                                "optimizer": {"t_total": 100},
                                "serialization_dir": out_dir}})
                for fn in flash_counted.values():
                    fn.launches = 0
                t = time.perf_counter()
                rc = cli.main(["train", EVAL_CONFIG, "-o", ovr] + extra)
                wall = time.perf_counter() - t
                check(rc == 0, f"train {extra} returned {rc}")
                got = {k: fn.launches for k, fn in flash_counted.items()}
                # 5 train steps and 1 val batch a run.
                check(got == {"flash_attention_fwd": per_step * 6,
                              "flash_attention_bwd": per_step * 5},
                      f"train {extra}: flash launches {got}")
                for name, n in got.items():
                    launches[name] += n
                traces = sorted(glob.glob(f"{out_dir}/profile/*.pt.trace.json"),
                                key=lambda p: p.rsplit(".", 4)[-4])
                check(len(traces) == len(summary["traces"]) + 1,
                      f"profile directory holds {traces}")
                new = [p for p in traces if p not in
                       {s["file"] for s in summary["traces"]}]
                counts = trace_counts(new[0])
                print(f"  train {' '.join(extra) or '(fresh)'}: {wall:.1f} s;"
                      f" trace {new[0].rsplit('/', 1)[1]}"
                      f" ({os.path.getsize(new[0]) / 2 ** 20:.1f} MiB):"
                      f" {counts}", flush=True)
                check(counts["flash_fwd_kernel"] == per_step * steps
                      and counts["flash_bwd_kernel"] == per_step * steps,
                      f"the window holds {counts}, expected"
                      f" {per_step * steps} flash forward and backward"
                      " kernels")
                check(counts["train_step.forward"] == steps,
                      f"the window holds {counts['train_step.forward']}"
                      f" train steps, expected {steps}")
                summary["traces"].append({"file": new[0], "wall_s": wall,
                                          **counts})
    finally:
        logging.getLogger("trainer").removeHandler(handler)
    opened = [m for m in messages if m.startswith("profiling steps")]
    print(f"  trainer: {opened}", flush=True)
    check(len(opened) == 2 and opened[0].startswith("profiling steps 2..5")
          and opened[1].startswith("profiling steps 5..8"),
          f"the windows opened at {opened}, expected steps 2 and 5")
    for t in summary["traces"]:
        t["file"] = t["file"].rsplit("/", 1)[1]
    return launches, summary


def moments_phase(torch, flash_counted):
    """Phase 22.2. 8 flagship train steps (bf16_o2, full width and depth)
    from the same seeded weights and synthetic batches, BertAdam's first
    moments in fp32 and in bf16: mu stored bf16, the bf16 run's losses
    finite and within rtol 0.05 of the fp32 run's; the optimizer's
    `apply` timed on each state. Returns the flash launches and a
    summary."""
    from news_image_caption_tpu_torch.config import (FLAGSHIP,
                                                     FLAGSHIP_ARTICLE_LEN,
                                                     FLAGSHIP_CAPTION_LEN,
                                                     FLAGSHIP_IMAGE_LEN,
                                                     FLAGSHIP_OPTIMIZER)
    from news_image_caption_tpu_torch.data.synthetic import (
        SyntheticNewsDataset, to_device)
    from news_image_caption_tpu_torch.training.builder import \
        flagship_trainer_builder
    from news_image_caption_tpu_torch.training.optim import make_bert_adam

    B, n = 16, 8
    ds = SyntheticNewsDataset(
        size=B * n, vocab_size=FLAGSHIP["vocab_size"],
        caption_len=FLAGSHIP_CAPTION_LEN, article_len=FLAGSHIP_ARTICLE_LEN,
        n_patches=FLAGSHIP_IMAGE_LEN, image_dim=FLAGSHIP["image_dim"],
        article_dim=FLAGSHIP["article_dim"], seed=0)
    batches = [to_device(b, "cuda") for b in ds.batches(B, seed=0)]
    losses, apply_ms, launches = {}, {}, dict.fromkeys(flash_counted, 0)
    for name, mdt in (("fp32", None), ("bf16", torch.bfloat16)):
        model, state, train_step, _ = flagship_trainer_builder(
            "cuda", seed=0, t_total=100, moment_dtype=mdt)
        inner = state.opt_state["inner"]
        want = mdt or torch.float32
        check(all(m.dtype == want for m in inner.mu)
              and all(v.dtype == torch.float32 for v in inner.nu),
              f"{name} moments: mu {inner.mu[0].dtype}, nu"
              f" {inner.nu[0].dtype}")
        for fn in flash_counted.values():
            fn.launches = 0
        traj = []
        for b in batches:
            state, m = train_step(state, b, 0)
            traj.append(m["loss"].item())
            check(m["skipped"] == 0, f"{name} moments: a step was skipped")
        for k, fn in flash_counted.items():
            check(fn.launches == 8 * n, f"{name} moments: {k} launched"
                  f" {fn.launches} times, expected {8 * n}")
            launches[k] += fn.launches
        losses[name] = traj
        tx = make_bert_adam(**{**FLAGSHIP_OPTIMIZER, "t_total": 100},
                            moment_dtype=mdt)
        master = [state.opt_state["master"][k] for k in state.opt_names]
        gen = torch.Generator(device="cuda").manual_seed(1)
        grads = [torch.randn(p.shape, device="cuda", generator=gen) * 1e-3
                 for p in master]
        apply_ms[name] = time_ms(lambda: tx.apply(grads, inner, master),
                                 iters=10)
        del model, state, train_step, master, grads, inner
        torch.cuda.empty_cache()
    print(f"  losses fp32 moments: {[round(x, 4) for x in losses['fp32']]}",
          flush=True)
    print(f"  losses bf16 moments: {[round(x, 4) for x in losses['bf16']]};"
          f" BertAdam.apply {apply_ms['fp32']:.4f} ms (fp32 mu) /"
          f" {apply_ms['bf16']:.4f} ms (bf16 mu), CUDA events, L2-cold",
          flush=True)
    check(all(np.isfinite(losses["bf16"])), "a bf16-moment loss is not"
          " finite")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["bf16"],
                                               losses["fp32"])]
    check(max(rel) <= 0.05, f"bf16-moment losses off the fp32 ones by"
          f" {max(rel):.4f} (rtol 0.05)")
    return launches, {"losses": losses, "max_rel_diff": max(rel),
                      "apply_ms": apply_ms}


def loaders_phase(torch, flash_counted, shard_paths):
    """Phase 22.3. The `Trainer` fed by a `FixedStepsLoader` of 3 steps
    an epoch over phase 18's two train shards (64 records, 4 batches of
    16 a seed): epoch 0, stopped, then `recover` into epoch 1; the
    resumed run's batches and the first run's must be the uninterrupted
    stream's (the shards' batches of seeds 0, 1, ... in turn) and its
    step count 6. Then a `TokenBucketBatcher` (max_tokens 16384, batches
    of 16) over the flagship YAML's 128 synthetic train records by
    article length, each batch padded to its bucket, through the train
    step: flash kernels at every bucket length, at least three of them.
    Returns the launches of both paths and a summary."""
    import itertools
    import tempfile

    from news_image_caption_tpu_torch.config import (FLAGSHIP_OPTIMIZER,
                                                     build_dataset,
                                                     load_config)
    from news_image_caption_tpu_torch.data.dataset import NicsShardDataset
    from news_image_caption_tpu_torch.data.loader import (DeviceLoader,
                                                          FixedStepsLoader,
                                                          TokenBucketBatcher)
    from news_image_caption_tpu_torch.data.synthetic import (LOSS_KEYS,
                                                            to_device)
    from news_image_caption_tpu_torch.training.builder import \
        flagship_trainer_builder
    from news_image_caption_tpu_torch.training.optim import make_bert_adam
    from news_image_caption_tpu_torch.training.trainer import (Trainer,
                                                               TrainerConfig)

    B, S = 16, 3
    ds = NicsShardDataset(paths=list(shard_paths))

    def make_batches(seed):
        return ds.batches(B, seed=seed)

    def key(b):
        return b["caption_ids"].tobytes() + b["article_ids"].tobytes()

    stream = itertools.chain.from_iterable(make_batches(s)
                                           for s in itertools.count())
    want = [key(b) for b in itertools.islice(stream, 2 * S)]
    fixed = FixedStepsLoader(make_batches, S, batches_per_seed=64 // B)
    launches = {"loaders_train": dict.fromkeys(flash_counted, 0)}
    seen = {}
    tx = make_bert_adam(**{**FLAGSHIP_OPTIMIZER, "t_total": 100})
    with tempfile.TemporaryDirectory() as tmp:
        for run, epochs, recover in (("stopped", 1, False),
                                     ("resumed", 2, True)):
            model, state, _, _ = flagship_trainer_builder(
                "cuda", seed=0, t_total=100)
            trainer = Trainer(model.loss_fn, tx, TrainerConfig(
                num_epochs=epochs, serialization_dir=tmp,
                mixed_precision="bf16_o2", log_every=S, keep_checkpoints=1,
                summary_interval=0))
            seen[run] = []

            def train_batches(epoch, run=run):
                for b in fixed.epoch(epoch):
                    seen[run].append((epoch, key(b)))
                    yield {k: b[k] for k in LOSS_KEYS}

            for fn in flash_counted.values():
                fn.launches = 0
            state = trainer.train(
                state, lambda e: DeviceLoader(train_batches(e), "cuda"),
                recover=recover)
            for k, fn in flash_counted.items():
                launches["loaders_train"][k] += fn.launches
            seen[run + "_steps"] = state.step
            seen[run + "_loss"] = [r["loss"] for r in trainer.history]
            del state, trainer, model
            torch.cuda.empty_cache()
    ds.close()
    stopped = [k for e, k in seen["stopped"]]
    resumed = [(e, k) for e, k in seen["resumed"]]
    check(stopped == want[:S], "epoch 0's batches are not the stream's")
    check([e for e, _ in resumed] == [1] * S
          and [k for _, k in resumed] == want[S:],
          "the resumed epoch's batches are not the uninterrupted stream's")
    check(launches["loaders_train"] == {"flash_attention_fwd": 16 * S,
                                         "flash_attention_bwd": 16 * S},
          f"the loader runs' flash launches {launches['loaders_train']}")
    check(seen["stopped_steps"] == S and seen["resumed_steps"] == 2 * S,
          f"steps {seen['stopped_steps']} then {seen['resumed_steps']},"
          f" expected {S} then {2 * S}")
    print(f"  FixedStepsLoader ({S} steps an epoch over 4 batches a seed):"
          f" epoch 0 then the resumed epoch 1 = the stream's batches 0-5,"
          f" steps {seen['stopped_steps']} -> {seen['resumed_steps']};"
          f" losses {seen['stopped_loss']} / {seen['resumed_loss']}",
          flush=True)

    # Bucketed batches of the flagship's synthetic train records.
    cfg = load_config(EVAL_CONFIG, json.dumps(
        {"dataset": {"train": {"size": 128}}}))
    syn = build_dataset(cfg, "train")
    batcher = TokenBucketBatcher(lambda ex: len(ex.article_ids),
                                 batch_size=B, max_tokens=16384)
    buckets = []
    _, state, train_step, _ = flagship_trainer_builder("cuda", seed=0,
                                                       t_total=100)
    for fn in flash_counted.values():
        fn.launches = 0
    per_bucket, losses = [], []
    for examples, bucket in batcher.batches(syn[i] for i in range(len(syn))):
        syn_b = type(syn)(**{**vars(syn), "article_len": bucket})
        batch = syn_b.collate(examples)
        check(batch["article"].shape[1] == bucket, "collate ignored the"
              " bucket")
        before = {k: fn.launches for k, fn in flash_counted.items()}
        state, m = train_step(state, to_device({k: batch[k] for k in
                                                LOSS_KEYS}, "cuda"), 0)
        losses.append(m["loss"].item())
        got = {k: fn.launches - before[k] for k, fn in flash_counted.items()}
        per_bucket.append((bucket, len(examples), got))
        buckets.append(bucket)
    launches["bucket_train"] = {k: fn.launches
                                for k, fn in flash_counted.items()}
    del state, train_step
    torch.cuda.empty_cache()
    print(f"  TokenBucketBatcher (max_tokens 16384): (bucket, rows, flash"
          f" launches) {per_bucket}; losses {[round(x, 3) for x in losses]}",
          flush=True)
    check(len(set(buckets)) >= 3, f"bucket lengths {sorted(set(buckets))}:"
          " fewer than three")
    check(all(np.isfinite(losses)), "a bucketed loss is not finite")
    check(all(g["flash_attention_fwd"] == 8 and g["flash_attention_bwd"] == 8
              for _, _, g in per_bucket),
          "a bucketed step did not launch 8 + 8 flash kernels")
    return launches, {"fixed_steps": {
        "steps_per_epoch": S, "steps": [seen["stopped_steps"],
                                        seen["resumed_steps"]],
        "losses": [seen["stopped_loss"], seen["resumed_loss"]]},
        "token_buckets": [{"bucket": b, "rows": r} for b, r, _ in
                          per_bucket], "bucket_losses": losses}


def beam_layouts_phase(torch, counted):
    """Phase 22.4. Beam-5 at B=16 (max_len 32, early exit) with phase 4's
    flagship weights (seed 0, bf16) through `generate_beam` with
    impl="shift", "lazy" and "topk". shift and lazy must give the same
    tokens bit for bit (both run the full-vocab head over the same
    kernels; only the caches' layout differs), each layer kernel launched
    its plan's count every step and the band kernel never; the share of
    their tokens equal to topk's is printed (both bf16, the heads sum
    differently, so ties may split). Prints each impl's kernel launches
    and device ms a step (one profiled search each). Returns each
    layout's launches and a summary."""
    from news_image_caption_tpu_torch.config import FLAGSHIP
    from news_image_caption_tpu_torch.generation.generator import \
        GenerationConfig
    from news_image_caption_tpu_torch.serving.worker import \
        flagship_model_builder
    from torch.profiler import ProfilerActivity, profile

    predict = flagship_model_builder("cuda", max_len=32)
    model, weights = predict.model, predict.weights
    B, K = 16, 5
    cfg = GenerationConfig(max_len=32, early_exit=True, beam_size=K)
    batch = stage_batch(torch, make_job(np.random.RandomState(22), B,
                                        np.random.RandomState(23).randint(
                                            20, 513, size=B)), "cuda")
    plan = beam_launches_a_step(torch, B * K, K)
    launches, out, summary = {}, {}, {"card": card_line()}
    for impl in ("topk", "shift", "lazy"):
        model.generate_beam(batch, cfg, weights, impl=impl)     # warm-up
        (tokens, scores), got, wall = counted_run(
            counted, lambda: model.generate_beam(batch, cfg, weights,
                                                 impl=impl))
        tokens, scores = tokens.cpu().numpy(), scores.cpu().numpy()
        check_beams(tokens, scores, B, cfg, FLAGSHIP["vocab_size"])
        n = decode_steps(tokens.reshape(-1, tokens.shape[-1]), cfg.eos_id,
                         cfg.max_len)
        per_step = dict(plan) if impl == "topk" else \
            dict(plan, band_topk_lse=0)
        check_launches(f"beam-5 B=16 impl={impl}", got, per_step, n)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model.generate_beam(batch, cfg, weights, impl=impl)
            torch.cuda.synchronize()
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")) / 1e3
        check(busy > 0, "the profiler saw no device time")
        out[impl] = tokens
        launches[f"beam5_{impl}"] = got
        summary[impl] = {"steps": n, "wall_ms": wall * 1e3,
                         "launches_a_step": {k: v / n for k, v in
                                             got.items()},
                         "device_ms_a_step": busy / n}
        print(f"  impl={impl}: {n} steps, {wall * 1e3:.1f} ms, launches a"
              f" step {summary[impl]['launches_a_step']}, device"
              f" {busy / n:.4f} ms a step (profiler)", flush=True)
    check(np.array_equal(out["shift"], out["lazy"]),
          "shift and lazy beams differ")
    same = float((out["shift"] == out["topk"]).all(-1).mean())
    first = float((out["shift"][:, 0] == out["topk"][:, 0]).all(-1).mean())
    summary.update(shift_equals_lazy=True, beams_equal_to_topk=same,
                   best_beams_equal_to_topk=first)
    print(f"  shift == lazy bit for bit; beams equal to topk's: {same:.3f}"
          f" (best beams {first:.3f})", flush=True)
    del launches["beam5_topk"]
    return launches, summary


def phase22(torch, flash, counted, shard_paths):
    """Phase 22: the profiler window, bf16 first moments, the step
    loaders and the shift and lazy beam layouts (22.1 to 22.4). Returns
    each path's launches and a summary."""
    flash_counted = {"flash_attention_fwd": flash.flash_attention_fwd,
                     "flash_attention_bwd": flash.flash_attention_bwd}
    t = time.perf_counter()
    launches, summary = {}, {}
    launches["profile_train"], summary["profile_window"] = \
        profile_window_phase(torch, flash_counted)
    launches["moments_train"], summary["moments"] = moments_phase(
        torch, flash_counted)
    more, summary["loaders"] = loaders_phase(torch, flash_counted,
                                             shard_paths)
    launches.update(more)
    more, summary["beam_layouts"] = beam_layouts_phase(torch, counted)
    launches.update(more)
    for path, counts in launches.items():
        check(any(counts.values()), f"phase 22 {path}: no kernel launched")
    summary["wall_s"] = time.perf_counter() - t
    return launches, summary


# Phase 23's option sets on the flagship (ROADMAP Queue 1 item 8b).
OPTION_SETS = {
    "A": dict(conv_type="lightweight", decoder_glu=False,
              weight_softmax=False, normalize_before=True, final_norm=True,
              conv_dim=512),
    "B": dict(remat=True, tie_adaptive_proj=True,
              adaptive_softmax_dropout=0.1),
}


def options_model(torch, opts: dict, device, dtype, seed: int = 0):
    """The flagship captioner with `opts`, its training dropouts and
    flash, random weights drawn on `device` from `seed`."""
    from news_image_caption_tpu_torch.config import FLAGSHIP, FLAGSHIP_TRAIN
    from news_image_caption_tpu_torch.models.captioner import \
        TransformerFlattened
    gen = torch.Generator(device=device).manual_seed(seed)
    return TransformerFlattened(device=device, dtype=dtype, generator=gen,
                                **FLAGSHIP, **FLAGSHIP_TRAIN, **opts)


def options_ops_phase(torch, flash, xattn, band) -> dict:
    """Phase 23.1: the kernels at the shapes the options give them."""
    from news_image_caption_tpu_torch.ops.adaptive import AdaptiveSoftmax
    from news_image_caption_tpu_torch.ops.attention import \
        MultiHeadAttention
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(23)
    E, H, B = 1024, 16, 16

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(bf16)

    errs = {}
    seed = torch.tensor([23], dtype=torch.int32, device=dev)
    for S, kdim in ((49, 2048), (512, 1024)):
        attn = MultiHeadAttention(E, H, kdim, use_bias=False,
                                  add_bias_kv=False, add_zero_attn=False,
                                  use_flash=True, device=dev, dtype=bf16,
                                  generator=gen)
        mask = torch.zeros(B, S, dtype=torch.bool, device=dev)
        mask[B // 2:, S // 2:] = True
        with torch.no_grad():
            kv = attn.precompute_kv(rn(B, S, kdim), rn(B, S, kdim), mask)
            check(kv.k.shape == (B, S, E), f"S' = {kv.k.shape[1]}, not {S}")
            q = attn.q_proj(rn(B, 63, E)) * (E // H) ** -0.5
            flash_case(torch, flash, f"no extra slots S'={S}", q.contiguous(),
                       kv.k, kv.v, rn(B, 63, E, scale=0.1), kv.bias, seed, H,
                       0.1)
            q1 = attn.q_proj(rn(B, 1, E)) * (E // H) ** -0.5
            errs[f"decode_cross_attention_S{S}"] = attention_case(
                torch, xattn, f"no extra slots S'={S}", q1.contiguous(),
                kv.k, kv.v, kv.bias, H)
    cut = (5000, 20000, 50265)
    sm = AdaptiveSoftmax(E, cut, factor=4.0, tied=False, device=dev,
                         dtype=bf16, generator=gen)
    x = rn(B, E)
    with torch.no_grad():
        bands = [(x, sm.head_table(None, bf16), cut[0])]
        for i in (1, 2):
            table = sm.word_table(i, None).contiguous()
            bands.append((sm.tail_hidden(x, i, None).contiguous(), table,
                          table.shape[0]))
        for h, table, sel in bands:
            for k in (1, 5):
                kv_, ki, kl = band.band_topk_lse(h, table, k, sel)
                pv, pi, pl = band.band_topk_lse_plain(h, table, k, sel)
                torch.cuda.synchronize()
                e_v, ok_v = within(kv_, pv, 0.03125, 0.0)
                e_l, ok_l = within(kl, pl, 1e-3, 1e-4)
                what = f"untied factor-4 band {tuple(table.shape)} k={k}"
                print(f"  band_topk_lse {what}: values {e_v:.3g} (tol"
                      f" 0.03125), lse {e_l:.3g} (tol 1e-3 + 1e-4|ref|), ids"
                      f" equal {(ki == pi).float().mean().item():.3f}",
                      flush=True)
                check(ok_v and ok_l and bool((ki < sel).all()),
                      f"band_topk_lse {what} disagrees with its plain twin")
                errs[what] = max(e_v, e_l)
    return errs


def options_batch(torch, B: int, seed: int):
    from news_image_caption_tpu_torch.config import (FLAGSHIP,
                                                     FLAGSHIP_ARTICLE_LEN,
                                                     FLAGSHIP_CAPTION_LEN,
                                                     FLAGSHIP_IMAGE_LEN)
    from news_image_caption_tpu_torch.data.synthetic import (
        SyntheticNewsDataset, to_device)
    ds = SyntheticNewsDataset(
        size=B, vocab_size=FLAGSHIP["vocab_size"],
        caption_len=FLAGSHIP_CAPTION_LEN, article_len=FLAGSHIP_ARTICLE_LEN,
        n_patches=FLAGSHIP_IMAGE_LEN, image_dim=FLAGSHIP["image_dim"],
        article_dim=FLAGSHIP["article_dim"], seed=seed)
    return to_device(next(ds.batches(B, shuffle=False)), "cuda")


def options_train(torch, flash, name: str, opts: dict) -> dict:
    """Phase 23.2: 8 bf16_o2 train steps at B=16; for a remat set, the
    loss and gradients with and without remat."""
    from news_image_caption_tpu_torch.config import FLAGSHIP_OPTIMIZER
    from news_image_caption_tpu_torch.training.optim import make_bert_adam
    from news_image_caption_tpu_torch.training.train_step import (
        cast_floats, create_o2_train_state, make_train_step)
    bf16 = torch.bfloat16
    model = options_model(torch, opts, "cuda", bf16)
    batch = options_batch(torch, 16, 0)
    out = {}
    if opts.get("remat"):
        dec = model.decoder
        runs = []
        for on in (False, True):
            dec.remat = on
            dec.zero_grad()
            loss = model.loss_fn(cast_floats(batch, bf16), torch.Generator(
                device="cuda").manual_seed(7))[0]
            loss.backward()
            runs.append((loss.item(), {k: p.grad.clone() for k, p in
                                       dec.named_parameters()}))
        dec.zero_grad()
        (l0, g0), (l1, g1) = runs
        worst, same = 0.0, l0 == l1
        for k in g0:
            e, ok = within(g1[k], g0[k],
                           0.02 * g0[k].float().abs().max().item(), 0.02)
            worst = max(worst, e)
            same = same and bool(torch.equal(g0[k], g1[k]))
            check(ok, f"set {name}: the remat gradient of {k} differs")
        print(f"  set {name} remat vs not, dropout on: loss {l1:.6f} vs"
              f" {l0:.6f} (tol 1%), gradients max |diff| {worst:.3g} (tol"
              f" 0.02 max|ref| + 0.02|ref|), bit-identical {same}",
              flush=True)
        check(abs(l1 - l0) <= 0.01 * abs(l0), f"set {name}: remat loss")
        out["remat_vs_not"] = {"loss": [l0, l1], "grad_max_abs_diff": worst,
                               "bit_identical": same}
        dec.remat = True
    tx = make_bert_adam(**dict(FLAGSHIP_OPTIMIZER, t_total=100))
    state = create_o2_train_state(model.decoder, tx)
    step = make_train_step(model.loss_fn, tx, compute_dtype=bf16)
    counted = {"flash_attention_fwd": flash.flash_attention_fwd,
               "flash_attention_bwd": flash.flash_attention_bwd}
    losses, walls = [], []
    for k in counted.values():
        k.launches = 0
    for _ in range(8):
        t = time.perf_counter()
        state, m = step(state, batch, 0)
        losses.append(m["loss"].item())
        walls.append(time.perf_counter() - t)
    got = {n: k.launches for n, k in counted.items()}
    fwd = 16 if opts.get("remat") else 8
    print(f"  set {name}: 8 train steps, losses " + " ".join(
        f"{x:.4f}" for x in losses) + f"; flash {got} (expected {fwd} + 8 a"
          f" step); step ms median {sorted(walls)[4] * 1e3:.1f}", flush=True)
    check(all(np.isfinite(losses)), f"set {name}: a train loss is not finite")
    check(got == {"flash_attention_fwd": 8 * fwd, "flash_attention_bwd": 64},
          f"set {name}: flash launches {got}")
    del state, step, model
    torch.cuda.empty_cache()
    out.update(losses=losses, flash_launches=got,
               step_ms_median=sorted(walls)[4] * 1e3)
    return out


def options_decode(torch, counted, name: str, opts: dict):
    """Phase 23.3: greedy and beam-5 at B=16 over 16 steps on the card,
    launches a step, step 0 against the fp32 plain path on the CPU, and
    (set A) speculative greedy against greedy. Returns (launches by
    path, a summary)."""
    from news_image_caption_tpu_torch.config import FLAGSHIP
    from news_image_caption_tpu_torch.generation.generator import \
        GenerationConfig
    B, steps = 16, 16
    model = options_model(torch, opts, "cuda", torch.bfloat16)
    model.decoder.eval()
    weights = model.decoder.decode_weights()
    job = make_job(np.random.RandomState(23), B,
                   np.random.RandomState(24).randint(20, 513, size=B))
    batch = stage_batch(torch, job, "cuda")
    cfg = GenerationConfig(max_len=steps, early_exit=False)
    fused = model.decoder.layers[0].fused_decode_ok()
    per_step = dict(greedy_launches_a_step())
    if not fused:
        per_step.update(decode_conv_block=0, decode_ffn_block=0)
    launches, out = {}, {"card": card_line(), "kernel_route": fused}
    with torch.inference_mode():
        model.generate(batch, cfg, weights)                 # warm-up
        (tok, lp), got, wall = counted_run(
            counted, lambda: model.generate(batch, cfg, weights))
        tok = tok.cpu().numpy()
        check_tokens(tok, B, cfg, FLAGSHIP["vocab_size"])
        check_launches(f"set {name} greedy", got, per_step, steps)
        launches[f"options_{name}_greedy"] = got
        out["greedy_ms"] = wall * 1e3
        bcfg = dataclasses.replace(cfg, beam_size=5)
        plan = beam_launches_a_step(torch, B * 5, 5)
        if not fused:
            plan.update(decode_conv_block=0, decode_ffn_block=0)
        (btok, bscores), got, wall = counted_run(
            counted, lambda: model.generate_beam(batch, bcfg, weights))
        btok, bscores = btok.cpu().numpy(), bscores.cpu().numpy()
        check_beams(btok, bscores, B, bcfg, FLAGSHIP["vocab_size"])
        check_launches(f"set {name} beam-5", got, plan, steps)
        launches[f"options_{name}_beam5"] = got
        out["beam5_ms"] = wall * 1e3
        if name == "A":
            source = np.concatenate([tok, tok], axis=1)
            sbatch = dict(batch, article_ids=torch.as_tensor(source).cuda())
            (stok, _, n_chunks), got, _ = counted_run(
                counted, lambda: model.generate_speculative(
                    sbatch, cfg, weights, spec_k=4))
            stok = stok.cpu().numpy()
            equal = float((stok == tok).all(-1).mean())
            print(f"  set {name} speculative greedy (spec_k 4, oracle"
                  f" drafts): {n_chunks} chunks for {steps} steps, rows"
                  f" equal to greedy {equal:.3f}", flush=True)
            check(equal == 1.0, f"set {name}: speculative tokens differ from"
                  " greedy's")
            launches[f"options_{name}_speculative"] = got
            out["speculative"] = {"chunks": int(n_chunks),
                                  "rows_equal_to_greedy": equal}
    # Step 0 against the fp32 plain path on the CPU, the same weights.
    t = time.perf_counter()
    cpu = options_model(torch, opts, "cpu", torch.float32)
    cpu.decoder.load_state_dict({k: v.float().cpu() for k, v in
                                 model.decoder.state_dict().items()})
    cpu.decoder.eval()
    del model, weights
    torch.cuda.empty_cache()
    with torch.inference_mode():
        cbatch = {k: (v.float() if v.is_floating_point() else v)
                  for k, v in stage_batch(torch, job, "cpu").items()}
        ctok, clp = cpu.generate(cbatch, cfg)
        kvs, caches, seed, w = cpu._decode_setup(cbatch, cfg, None, 1)
        top2, _ = cpu.decoder.step_topk(seed, 0, kvs, caches, 2, w)
    ctok = ctok.numpy()
    lead = (top2[:, 0] - top2[:, 1]).numpy()
    decided = lead > 0.2
    same0 = tok[:, 1] == ctok[:, 1]
    e0 = float(np.abs(lp.cpu().numpy()[:, 0] - clp.numpy()[:, 0]).max())
    agree = float((tok[:, 1:] == ctok[:, 1:]).mean())
    beam_first = float(np.mean([ctok[i, 1] in btok[i, :, 1]
                                for i in range(B)]))
    print(f"  set {name} vs the fp32 plain path on the CPU"
          f" ({time.perf_counter() - t:.1f} s): step-0 tokens equal"
          f" {same0.mean():.3f} (min 0.75; {decided.sum()} rows lead by"
          f" > 0.2, all equal: {bool(same0[decided].all())}), step-0"
          f" log-prob max |diff| {e0:.4g} (tol 0.1), token agreement over"
          f" {steps} steps {agree:.3f}; items whose beams start with the"
          f" plain path's greedy token {beam_first:.3f}", flush=True)
    check(bool(same0[decided].all()), f"set {name}: a decided step-0 token"
          " differs from the fp32 plain path's")
    check(same0.mean() >= 0.75 and e0 <= 0.1,
          f"set {name}: step 0 differs from the fp32 plain path")
    out.update(step0_tokens_equal=float(same0.mean()),
               step0_rows_decided=int(decided.sum()),
               step0_logprob_max_abs_diff=e0, token_agreement=agree,
               beams_holding_plain_first_token=beam_first)
    return launches, out


def options_phase(torch, flash, counted, ops):
    """Phase 23. Returns (each path's launches, a summary)."""
    xattn, band = ops
    t = time.perf_counter()
    summary = {"ops": options_ops_phase(torch, flash, xattn, band),
               "card": card_line()}
    launches = {}
    for name, opts in OPTION_SETS.items():
        summary[f"train_{name}"] = options_train(torch, flash, name, opts)
        launches[f"options_{name}_train"] = \
            summary[f"train_{name}"]["flash_launches"]
        more, summary[f"decode_{name}"] = options_decode(torch, counted,
                                                         name, opts)
        launches.update(more)
    for path, counts in launches.items():
        check(any(counts.values()), f"phase 23 {path}: no kernel launched")
    summary["wall_s"] = time.perf_counter() - t
    return launches, summary


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def encoder_forms(torch):
    """Phase 24.3: RoBERTa-large at full width (the online pipeline's
    encoder, `PIPELINE_CONFIG`, seeded random weights, fp32 with TF32
    off) on the config's first 16 test articles: the ring form over a
    `context` axis of one and the pipelined form over a `pipe` axis of
    one (n_micro 2), against the dense encoder. The YAML forms `ring:
    {context: 1}` and `pipe: {pipe: 1}` leave no such axis (`make_mesh`
    drops axes of one, as the reference's does) and the reference's ring
    attention and pipeline raise on a mesh without their axis, so the
    phase gives the encoder meshes that keep their axis of one."""
    from torch.distributed.device_mesh import init_device_mesh

    from news_image_caption_tpu_torch.config import build_dataset, load_config
    from news_image_caption_tpu_torch.models.facenet import fp32_exact
    from news_image_caption_tpu_torch.models.roberta import RobertaEncoder
    from news_image_caption_tpu_torch.parallel import distributed as pdist

    cfg = load_config(PIPELINE_CONFIG,
                      json.dumps({"dataset": {"test": {"size": 16}}}))
    ids = torch.from_numpy(next(build_dataset(cfg, "test").batches(
        16, shuffle=False))["article_ids"]).cuda()
    enc = RobertaEncoder(device="cuda", dtype=torch.float32,
                         generator=torch.Generator(device="cuda")
                         .manual_seed(0)).eval()
    pdist.ensure_world("cuda")
    try:
        names = ("data", "model")
        ring = init_device_mesh("cuda", (1, 1, 1),
                                mesh_dim_names=names + ("context",))
        pipe = init_device_mesh("cuda", (1, 1, 1),
                                mesh_dim_names=names + ("pipe",))
        out, ms = {}, {}
        with torch.no_grad(), fp32_exact():
            for form in ("dense", "ring", "pipe"):
                enc.ring_mesh = ring if form == "ring" else None
                run = ((lambda: enc.encode_pipelined(ids, pipe, 2))
                       if form == "pipe" else (lambda: enc(ids)[0]))
                out[form], ms[form] = events_ms(torch, run)
        enc.ring_mesh = None
    finally:
        pdist.shutdown()
    errs = {form: (out[form] - out["dense"]).abs().max().item()
            for form in ("ring", "pipe")}
    scale = out["dense"].abs().max().item()
    print(f"  RoBERTa-large fp32 (TF32 off), {tuple(ids.shape)} ids: ring"
          f" (context 1) max |diff| {errs['ring']:.3g}, pipelined (pipe 1,"
          f" n_micro 2) {errs['pipe']:.3g} against the dense encoder (tol"
          f" 1e-3; max |dense| {scale:.3g}); ms dense {ms['dense']:.2f} ring"
          f" {ms['ring']:.2f} pipe {ms['pipe']:.2f}", flush=True)
    check(all(np.isfinite(e) and e <= 1e-3 for e in errs.values()),
          "the ring or pipelined encoder disagrees with the dense one")
    return {"ids": list(ids.shape), "max_abs_diff": errs,
            "max_abs_dense": scale, "ms": ms}


def epoch_medians(step_s: list, epochs: int) -> list:
    """The median step ms of each epoch (host clock)."""
    n = len(step_s) // epochs
    return [sorted(step_s[e * n:(e + 1) * n])[n // 2] * 1e3
            for e in range(epochs)]


def mesh_train(torch, flash_counted, phase8, out_dir: str, **trainer):
    """Phase 8's train command plus `trainer.distributed` (one process at
    a free local port), `trainer.mesh: {data: 1, model: 1}` and
    `trainer`: one NCCL process group, ended with the command, both
    models through `shard_params` at a model axis of one (the split
    code, phase 25), flash launches as phase 8's and its records bit for
    bit. Returns (the config, its overrides, the command's timings, its
    wall seconds, the flash launches)."""
    import torch.distributed as dist

    from news_image_caption_tpu_torch import cli
    from news_image_caption_tpu_torch.config import FLAGSHIP, load_config

    overrides = train_command_overrides(out_dir)
    overrides["trainer"].update(
        distributed={"coordinator_address": f"127.0.0.1:{free_port()}",
                     "num_processes": 1, "process_id": 0},
        mesh={"data": 1, "model": 1}, **trainer)
    ovr = json.dumps(overrides)
    print(f"  phase 8's cuts plus {json.dumps({k: overrides['trainer'][k] for k in ('distributed', 'mesh', *trainer)})}",
          flush=True)
    cfg = load_config(EVAL_CONFIG, ovr)
    B = cfg["iterator"]["batch_size"]
    epochs = cfg["trainer"]["num_epochs"]
    steps = epochs * (cfg["dataset"]["train"]["size"] // B)
    val_batches = epochs * (cfg["dataset"]["val"]["size"] // B)
    backends, timings = [], {}
    real_init = dist.init_process_group

    def recording_init(backend=None, *args, **kw):
        backends.append(backend)
        return real_init(backend, *args, **kw)

    # The split code at a model axis of one (phase 25): every model the
    # command builds goes through `shard_params`.
    real_shard, splits = cli.shard_params, []

    def recording_shard(module, mesh, *args):
        out = real_shard(module, mesh, *args)
        splits.append((len(out), module.model_shard.size))
        return out

    for fn in flash_counted.values():
        fn.launches = 0
    dist.init_process_group = recording_init
    cli.shard_params = recording_shard
    try:
        t = time.perf_counter()
        rc = cli.main(["train", EVAL_CONFIG, "-o", ovr], timings=timings)
        wall = time.perf_counter() - t
    finally:
        dist.init_process_group = real_init
        cli.shard_params = real_shard
    launches = {n: fn.launches for n, fn in flash_counted.items()}
    check(rc == 0, f"train with the mesh returned {rc}")
    # bf16_o2: the fp32 model and its bf16 copy, 75 split parameters each.
    print(f"  shard_params calls (split parameters, model axis): {splits}",
          flush=True)
    check(splits == [(75, 1), (75, 1)], "the train command on the mesh did"
          " not go through the split code")
    check(backends == ["nccl"] and not dist.is_initialized(),
          f"process groups {backends}: expected one NCCL group, ended")
    n_layers = FLAGSHIP["num_layers"]
    want = {"flash_attention_fwd": 2 * n_layers * (steps + val_batches),
            "flash_attention_bwd": 2 * n_layers * steps}
    print(f"  flash launches {launches} (expected {want}); process group"
          f" backends {backends}", flush=True)
    check(launches == want, "flash launches of the train command on a mesh")
    with open(f"{out_dir}/metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    strip = [{k: v for k, v in r.items() if k != "input_wait"}
             for r in recs]
    want_recs = [{k: v for k, v in r.items() if k != "input_wait"}
                 for r in phase8["records"]]
    same = strip == want_recs
    print("  losses with the mesh: " + "; ".join(
        f"{r['split']} step {r['step']} {r['loss']!r}" for r in recs)
        + f"; equal to phase 8's bit for bit: {same}", flush=True)
    check(same, "the train command's records with the mesh differ from"
          " phase 8's without it")
    return cfg, ovr, timings, wall, launches


def mesh_phase(torch, flash, counted, phase8, phase8_summary):
    """Phase 24. The train command with phase 8's overrides plus
    `trainer.distributed`, `trainer.mesh: {data: 1, model: 1}` and
    `checkpoint_format: sharded` (`mesh_train`): one rank on NCCL, the
    data-parallel step, the sharded store; then the same with the
    single-file store (`mesh_train_single`), so the step with and
    without the mesh is read on one store and the sharded store's cost
    apart. Both runs' records must equal phase 8's bit for bit. Then
    `evaluate -m best` from the sharded store, byte-equal to evaluate of
    the same params through a `.pt` store (and to phase 8's); DCP's save
    and load against `torch.save` / `torch.load` of the same state (warm
    page cache); the gradient all-reduce of one step's fp32 gradients on
    NCCL at one rank; and the encoder forms. Returns ({path: {kernel:
    launches}}, summary)."""
    import tempfile

    import torch.distributed as dist
    from torch.utils._pytree import tree_leaves

    from news_image_caption_tpu_torch import cli
    from news_image_caption_tpu_torch.parallel import distributed as pdist
    from news_image_caption_tpu_torch.parallel.collectives import \
        GradientBuffer
    from news_image_caption_tpu_torch.training.checkpoint import \
        CheckpointStore
    from news_image_caption_tpu_torch.training.checkpoint_sharded import \
        ShardedCheckpointStore

    flash_counted = {"flash_attention_fwd": flash.flash_attention_fwd,
                     "flash_attention_bwd": flash.flash_attention_bwd}
    with tempfile.TemporaryDirectory() as tmp:
        _, _, single, _, single_launches = mesh_train(
            torch, flash_counted, phase8, f"{tmp}/single")
        shutil.rmtree(f"{tmp}/single")
        out_dir = f"{tmp}/serialization"
        cfg, ovr, timings, wall, train_launches = mesh_train(
            torch, flash_counted, phase8, out_dir,
            checkpoint_format="sharded")
        epochs = cfg["trainer"]["num_epochs"]
        ckpt_dir = f"{out_dir}/checkpoints"
        store = ShardedCheckpointStore(ckpt_dir)
        per_epoch = len(timings["step_s"]) // epochs
        check([c["step"] for c in store.meta["checkpoints"]]
              == [per_epoch, 2 * per_epoch], f"meta.json {store.meta}")
        files = sorted(os.listdir(f"{ckpt_dir}/ckpt_{per_epoch}"))
        check(".metadata" in files and "__0_0.distcp" in files,
              f"a sharded checkpoint holds {files}")
        step_s = sorted(timings["step_s"])
        step_ms = step_s[len(step_s) // 2] * 1e3
        saves = [(c["step"], round(c["snapshot_s"], 3), round(c["write_s"], 3))
                 for c in timings["checkpoints"]]
        by_epoch = {"phase8": epoch_medians(phase8["step_s"], epochs),
                    "mesh_single": epoch_medians(single["step_s"], epochs),
                    "mesh_sharded": epoch_medians(timings["step_s"], epochs)}

        # evaluate -m best from the sharded store, and through a .pt
        # store of the same state.
        t = time.perf_counter()
        tree = store.read("best")
        dcp_load_s = time.perf_counter() - t
        best = store.meta["best"]
        for fn in counted.values():
            fn.launches = 0
        rc = cli.main(["evaluate", EVAL_CONFIG, "-o", ovr, "-m", "best", "-s",
                       "_best"])
        check(rc == 0, f"evaluate from the sharded store returned {rc}")
        eval_launches = {n: fn.launches for n, fn in counted.items()}
        with open(f"{out_dir}/generations_best.jsonl", "rb") as f:
            from_sharded = f.read()
        pt_dir = f"{tmp}/pt"
        CheckpointStore(f"{pt_dir}/checkpoints").save(
            tree, best["step"], next(c["metrics"] for c in
                                     store.meta["checkpoints"]
                                     if c["step"] == best["step"]))
        pt_over = train_command_overrides(pt_dir)
        rc = cli.main(["evaluate", EVAL_CONFIG, "-o", json.dumps(pt_over),
                       "-m", "best", "-s", "_best"])
        check(rc == 0, f"evaluate from the .pt store returned {rc}")
        with open(f"{pt_dir}/generations_best.jsonl", "rb") as f:
            from_pt = f.read()
        shutil.rmtree(pt_dir)
        print(f"  evaluate -m best (step {best['step']}) from the sharded"
              f" store: {len(from_sharded)} bytes, byte-equal to the .pt"
              f" store's {from_sharded == from_pt} and to phase 8's"
              f" {from_sharded == phase8['generations_best']}; decode"
              f" launches {eval_launches}", flush=True)
        check(from_sharded == from_pt, "evaluate from the sharded store"
              " differs from the .pt store's")
        check(from_sharded == phase8["generations_best"], "evaluate from the"
              " sharded store differs from phase 8's")

        # DCP against torch.save / torch.load of the same state.
        t = time.perf_counter()
        ShardedCheckpointStore(f"{tmp}/dcp").save(tree, best["step"])
        dcp_save_s = time.perf_counter() - t
        shutil.rmtree(f"{tmp}/dcp")
        t = time.perf_counter()
        torch.save(tree, f"{tmp}/state.pt")
        torch_save_s = time.perf_counter() - t
        t = time.perf_counter()
        torch.load(f"{tmp}/state.pt", weights_only=True)
        torch_load_s = time.perf_counter() - t
        state_gb = sum(v.numel() * v.element_size() for v in
                       tree_leaves(tree) if isinstance(v, torch.Tensor)) / 1e9
    sizes = [v.numel() for v in tree["params"].values()]
    del tree
    # The step's gradient all-reduce: every trainable parameter's fp32
    # gradient in the step's flat buffer, summed in place on NCCL at one
    # rank; and the buffer's fill from the bf16 gradients of bf16_o2.
    pdist.ensure_world("cuda")
    try:
        grads = [torch.zeros(n, device="cuda", dtype=torch.bfloat16)
                 for n in sizes]
        buf = GradientBuffer(grads)
        allreduce_ms = time_ms(lambda: buf.all_reduce(dist.group.WORLD))
        fill_ms = time_ms(lambda: buf.fill(grads))
        del grads, buf
    finally:
        pdist.shutdown()
    single_s = sorted(single["step_s"])
    single_ms = single_s[len(single_s) // 2] * 1e3
    print(f"  train command with the mesh {wall:.1f} s; step median"
          f" {step_ms:.2f} ms (sharded store), {single_ms:.2f} ms (single"
          f" files) against phase 8's"
          f" {phase8_summary['step_ms_median']:.2f} ms without the mesh"
          f" (host clock); epoch medians {by_epoch} ms; gradient"
          f" all-reduce {allreduce_ms:.3f} ms a step"
          f" ({sum(sizes) * 4 / 1e9:.2f} GB fp32 in place, NCCL, one rank;"
          f" the buffer's fill from bf16 {fill_ms:.3f} ms); sharded"
          f" saves (step, snapshot s, write s) {saves}; the best state"
          f" ({state_gb:.2f} GB): DCP save {dcp_save_s:.2f} s, load"
          f" {dcp_load_s:.2f} s; torch.save {torch_save_s:.2f} s, torch.load"
          f" {torch_load_s:.2f} s (warm page cache)", flush=True)
    summary = {"wall_s": wall, "step_ms_median": step_ms,
               "single_file_step_ms_median": single_ms,
               "phase8_step_ms_median": phase8_summary["step_ms_median"],
               "epoch_median_ms": by_epoch, "step_s": timings["step_s"],
               "single_file_step_s": single["step_s"],
               "sharded_saves": saves,
               "grad_allreduce_ms": allreduce_ms,
               "grad_fill_ms": fill_ms,
               "grad_bytes": sum(sizes) * 4, "state_gb": state_gb,
               "dcp_save_s": dcp_save_s, "dcp_load_s": dcp_load_s,
               "torch_save_s": torch_save_s, "torch_load_s": torch_load_s,
               "records_equal_phase8": True,
               "evaluate_equal_pt_store": True, "card": card_line()}
    summary["encoders"] = encoder_forms(torch)
    return {"mesh_train": train_launches,
            "mesh_train_single": single_launches,
            "mesh_evaluate": eval_launches}, summary


# -- phase 25: tensor parallelism's shard forms ---------------------------

def shard_cols(t, r: int, n: int):
    """Columns [r n, (r + 1) n) of t's last dim, contiguous."""
    return t[..., r * n:(r + 1) * n].contiguous()


def shard_window(torch, fns, run):
    """run() with the launch counts of the wrappers `fns` ({entry name:
    wrapper}) set to 0, the card synchronized after it: (its result,
    {entry name: launches}). Only shard forms run inside, so the counts
    are theirs."""
    for fn in fns.values():
        fn.launches = 0
    out = run()
    torch.cuda.synchronize()
    return out, {name: fn.launches for name, fn in fns.items()}


def add_counts(total: dict, counts: dict) -> None:
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n


def shard_flash(torch, flash, tallies, launches, B: int = 16,
                T: int = 63) -> dict:
    """25.1. Flash forward and backward over each rank's heads [r H/m,
    (r + 1) H/m) with h0 and the whole head count, at phase 5's shapes
    (S' = 514 and 51, p = 0.1), for m = 2 and 4: every rank's out, lse,
    dq, dk and dv against the plain versions on its inputs at phase 3's
    tolerances (the errors go into `tallies`), and concatenated, bit for
    bit the whole launch's. The ranks' launches are counted into
    `launches`. Rank 0's forms at m = 2 are timed beside the whole
    launch and go into `tallies` (a train step's 4 calls of each S');
    every form's time is returned."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(25)
    E, H, p = 1024, 16, 0.1
    seed = torch.tensor([1234], dtype=torch.int32, device=dev)
    fwd, bwd = (tallies["flash_attention_fwd_shard"],
                tallies["flash_attention_bwd_shard"])
    times = {}

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(torch.bfloat16)

    def rank_kw(m, r):
        return dict(h0=r * (H // m), heads_total=H)

    for S in (514, 51):
        q, k, v = rn(B, T, E, scale=0.125), rn(B, S, E), rn(B, S, E)
        g = rn(B, T, E, scale=0.1)
        bias = torch.zeros(B, S, device=dev)
        bias[B // 2:, S // 2:max(S - 2, S // 2)] = -1e9
        out, lse = flash.flash_attention_fwd(q, k, v, bias, seed, H, p)
        whole = (out, lse) + tuple(flash.flash_attention_bwd(
            q, k, v, bias, seed, lse, g, H, p))
        times[f"S={S} whole"] = {
            "fwd": time_ms(lambda: flash.flash_attention_fwd(
                q, k, v, bias, seed, H, p)),
            "bwd": time_ms(lambda: flash.flash_attention_bwd(
                q, k, v, bias, seed, lse, g, H, p))}
        ins = {m: [tuple(shard_cols(t, r, H // m * 64) for t in (q, k, v, g))
                   for r in range(m)] for m in (2, 4)}

        def ranks():
            parts = {}
            for m in (2, 4):
                parts[m] = []
                for r, (qs, ks, vs, gs) in enumerate(ins[m]):
                    o, ls = flash.flash_attention_fwd(
                        qs, ks, vs, bias, seed, H // m, p, **rank_kw(m, r))
                    parts[m].append((o, ls) + tuple(flash.flash_attention_bwd(
                        qs, ks, vs, bias, seed, ls, gs, H // m, p,
                        **rank_kw(m, r))))
            return parts

        parts, counts = shard_window(
            torch, {"flash_attention_fwd_shard": flash.flash_attention_fwd,
                    "flash_attention_bwd_shard": flash.flash_attention_bwd},
            ranks)
        add_counts(launches, counts)
        for m in (2, 4):
            n = H // m
            worst = [0.0] * 5
            for r, ((qs, ks, vs, gs), got) in enumerate(zip(ins[m],
                                                            parts[m])):
                kw = rank_kw(m, r)
                pout, plse = flash.flash_attention_fwd_plain(
                    qs, ks, vs, bias, seed, n, p, **kw)
                pgrads = flash.flash_attention_bwd_plain(
                    qs, ks, vs, bias, seed, plse, gs, n, p, **kw)
                errs, oks = flash_errors(got, (pout, plse, *pgrads))
                check(all(oks), f"flash shard form S'={S} m={m} rank {r}"
                      f" disagrees with its plain twin: {errs}")
                fwd.errs += errs[:2]
                bwd.errs += errs[2:]
                worst = [max(a, b) for a, b in zip(worst, errs)]
            qs, ks, vs, gs = ins[m][0]
            kw = rank_kw(m, 0)
            o, ls, *grads = parts[m][0]
            times[f"S={S} m={m} rank0"] = {
                "fwd": time_ms(lambda: flash.flash_attention_fwd(
                    qs, ks, vs, bias, seed, n, p, **kw)),
                "bwd": time_ms(lambda: flash.flash_attention_bwd(
                    qs, ks, vs, bias, seed, ls, gs, n, p, **kw))}
            if m == 2:
                flops = 4.0 * B * T * S * n * 64
                lq, lk, lv = (t.detach().requires_grad_()
                              for t in (qs, ks, vs))
                lout = sdpa(torch, lq, lk, lv, bias, n, p)
                line = fwd.add(
                    (qs, ks, vs, bias, seed, o, ls), flops,
                    times[f"S={S} m={m} rank0"]["fwd"],
                    time_ms(lambda: flash.flash_attention_fwd_plain(
                        qs, ks, vs, bias, seed, n, p, **kw)),
                    time_ms(lambda: sdpa(torch, qs, ks, vs, bias, n, p)),
                    calls=4)
                print(f"    time flash_attention_fwd shard S'={S} m=2"
                      f" rank 0: {line}")
                line = bwd.add(
                    (qs, ks, vs, bias, seed, ls, gs, *grads), 2.5 * flops,
                    times[f"S={S} m={m} rank0"]["bwd"],
                    time_ms(lambda: flash.flash_attention_bwd_plain(
                        qs, ks, vs, bias, seed, ls, gs, n, p, **kw)),
                    time_ms(lambda: torch.autograd.grad(
                        lout, (lq, lk, lv), gs, retain_graph=True)),
                    calls=4)
                print(f"    time flash_attention_bwd shard S'={S} m=2"
                      f" rank 0: {line}")
            dims = (-1, 1, -1, -1, -1)
            same = [bool(torch.equal(torch.cat([pt[i] for pt in parts[m]],
                                               dim=dims[i]), whole[i]))
                    for i in range(5)]
            print(f"  flash B={B} T={T} S'={S} m={m}: every rank against"
                  f" its plain twin out {worst[0]:.3g}, lse {worst[1]:.3g},"
                  f" dq {worst[2]:.3g}, dk {worst[3]:.3g}, dv"
                  f" {worst[4]:.3g} (phase 3's tolerances); the {m} ranks'"
                  f" heads concatenated bit-equal to the whole launch (out,"
                  f" lse, dq, dk, dv) {same}; rank 0 fwd"
                  f" {times[f'S={S} m={m} rank0']['fwd']:.4f} ms, bwd"
                  f" {times[f'S={S} m={m} rank0']['bwd']:.4f} ms; whole fwd"
                  f" {times[f'S={S} whole']['fwd']:.4f} ms, bwd"
                  f" {times[f'S={S} whole']['bwd']:.4f} ms", flush=True)
            check(all(same), f"flash shard forms at m={m}, S'={S} differ"
                  " from the whole launch")
    return times


# The partial mode against its plain twin: fp32 sums of the same bf16
# products in another order, the hidden row rounded to bf16 from sums of
# another order. A rounding that flips moves one term h w2 by 2^-8 of
# it, at most 5 * 0.08 / 256 = 1.6e-3 at these inputs' scales, in sums
# of magnitude about 0.5; a group, b1 or a column of w2 missed, or b2
# or x added, would be off by 0.03 or more.
PARTIAL_TOL = (2e-3, 1e-3)


def shard_ffn(torch, blocks, tally, launches) -> dict:
    """25.2. `decode_ffn_block`'s partial mode over each rank's F/m
    columns of w1 and rows of w2 at N = 16 and 80 (m = 2, 4): every
    rank's fp32 partial against `decode_ffn_block_partial_plain` on its
    inputs within PARTIAL_TOL (the errors go into `tally`); the partials
    summed in rank order, then b2 and x (`ffn_epilogue`), within phase
    3's FFN tolerance (0.02 abs + rel) of the whole kernel; at m = 1 the
    partial mode plus the epilogue is the whole kernel bit for bit. The
    ranks' launches are counted into `launches`. Rank 0's partial at
    m = 2 is timed and tallied (4 layers of a greedy step, N = 16)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(26)
    D, F = 1024, 4096

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(torch.bfloat16)

    f1, fb1 = rn(D, F, scale=D ** -0.5), rn(F, scale=0.05)
    f2, fb2 = rn(F, D, scale=F ** -0.5), rn(D, scale=0.05)
    shards = {m: [(f1[:, r * (F // m):(r + 1) * (F // m)].contiguous(),
                   fb1[r * (F // m):(r + 1) * (F // m)].contiguous(),
                   f2[r * (F // m):(r + 1) * (F // m)].contiguous())
                  for r in range(m)] for m in (2, 4)}
    times = {}
    for N in (16, 80):
        x = rn(N, D)
        parts, counts = shard_window(
            torch, {"decode_ffn_block_partial":
                    blocks.decode_ffn_block_partial},
            lambda: {m: [blocks.decode_ffn_block_partial(x, *w)
                         for w in shards[m]] for m in (2, 4)})
        add_counts(launches, counts)
        whole = blocks.decode_ffn_block(x, f1, fb1, f2, fb2)
        one = blocks.ffn_epilogue(blocks.decode_ffn_block_partial(
            x, f1, fb1, f2), fb2, x)
        torch.cuda.synchronize()
        check(bool(torch.equal(one, whole)), f"FFN N={N}: the partial mode"
              " plus the epilogue at one rank differs from the whole kernel")
        times[f"N={N} whole"] = time_ms(
            lambda: blocks.decode_ffn_block(x, f1, fb1, f2, fb2))
        for m in (2, 4):
            n = F // m
            worst = 0.0
            for r, (w, got) in enumerate(zip(shards[m], parts[m])):
                e, ok = within(got, blocks.decode_ffn_block_partial_plain(
                    x, *w), *PARTIAL_TOL)
                check(ok, f"FFN partial N={N} m={m} rank {r} disagrees"
                      f" with its plain twin: {e:.3g}")
                tally.errs.append(e)
                worst = max(worst, e)
            y = blocks.ffn_epilogue(sum(parts[m]), fb2, x)
            e, ok = within(y, whole, 0.02, 0.02)
            w1, b1, w2 = shards[m][0]
            t = time_ms(lambda: blocks.decode_ffn_block_partial(x, w1, b1,
                                                                w2))
            times[f"N={N} m={m} rank0"] = t
            print(f"  decode_ffn_block partial N={N} F/m={n} (m={m}): every"
                  f" rank's fp32 partial against its plain twin {worst:.3g}"
                  f" (tol {PARTIAL_TOL[0]} + {PARTIAL_TOL[1]}|ref|); the"
                  f" partials summed + b2 + x against the whole kernel"
                  f" {e:.3g} (tol 0.02 + 0.02|ref|); rank 0 {t:.4f} ms"
                  f" against the whole {times[f'N={N} whole']:.4f} ms; at"
                  f" m=1 bit-equal True", flush=True)
            check(ok, f"FFN partial forms at m={m}, N={N} disagree with the"
                  " whole kernel")
            if N == 16 and m == 2:
                plain = blocks.decode_ffn_block_partial_plain
                line = tally.add(
                    (x, w1, b1, w2, parts[m][0]), 4.0 * N * D * n, t,
                    time_ms(lambda: plain(x, w1, b1, w2)),
                    time_ms(lambda: torch.nn.functional.linear(torch.relu(
                        torch.nn.functional.linear(x, w1.T, b1)), w2.T)),
                    calls=4)
                print(f"    time decode_ffn_block_partial N=16 m=2 rank 0:"
                      f" {line}")
    return times


def library_band(torch, x, table, sel: int):
    """The band's library chain (phase 3's): the bf16 product, logsumexp,
    topk over the selectable ids."""
    logits = (x @ table.T).float()
    return torch.logsumexp(logits, -1), torch.topk(logits[:, :sel], 1)


def shard_band(torch, band, tally, launches) -> dict:
    """25.3. `band_topk_lse` over each rank's rows of the head band
    (5000 words, the two class rows in rank 0's table, selectable below
    its words) and of band 1 (15000 rows) at N = 16 and 80, k = 1 and 5,
    m = 2 and 4: every rank's values, ids and logsumexp against
    `band_topk_lse_plain` on its rows at phase 3's tolerances (the
    errors go into `tally`); then the ids offset by the rank's first row
    and merged (`ops/adaptive.py::merge_candidates`): ids equal to the
    whole kernel's, values equal, the logsumexp within 1e-6 relative.
    The ranks' launches are counted into `launches`. Rank 0's form at
    m = 2, N = 16, k = 1 is timed and tallied (both bands)."""
    from news_image_caption_tpu_torch.ops.adaptive import merge_candidates
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(27)
    D = 1024

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(torch.bfloat16)

    times = {}
    for name, V, words in (("head", 5002, 5000), ("band1", 15000, 15000)):
        table = rn(V, D, scale=D ** -0.5)
        rows_of = {}
        for m in (2, 4):
            n = words // m
            rows_of[m] = [(torch.cat([table[:n], table[words:]]) if r == 0
                           else table[r * n:(r + 1) * n]).contiguous()
                          for r in range(m)]
        for N in (16, 80):
            x = rn(N, D)
            got, counts = shard_window(
                torch, {"band_topk_lse_shard": band.band_topk_lse},
                lambda: {(m, k): [band.band_topk_lse(x, rows, k, words // m)
                                  for rows in rows_of[m]]
                         for m in (2, 4) for k in (1, 5)})
            add_counts(launches, counts)
            worst = [0.0, 0.0, 0.0]
            for k in (1, 5):
                want = band.band_topk_lse(x, table, k, words)
                for m in (2, 4):
                    n = words // m
                    every = []
                    for r, (rows, (v, i, l)) in enumerate(zip(rows_of[m],
                                                              got[m, k])):
                        pv, pi, pl = band.band_topk_lse_plain(x, rows, k, n)
                        logits = (x.float() @ rows.float().T).to(
                            torch.bfloat16).float()
                        e_v, ok_v = within(v, pv, 0.03125, 0.0)
                        e_l, ok_l = within(l, pl, 1e-3, 1e-4)
                        e_i, ok_i = within(torch.gather(logits, 1, i.long()),
                                           pv, 0.03125, 0.0)
                        ok_sel = bool(((i >= 0) & (i < n)).all())
                        check(ok_v and ok_l and ok_i and ok_sel,
                              f"band_topk_lse shard {name} N={N} k={k} m={m}"
                              f" rank {r} disagrees with its plain twin:"
                              f" values {e_v:.3g}, lse {e_l:.3g}, logit at"
                              f" ids {e_i:.3g}, ids in range {ok_sel}")
                        tally.errs += [e_v, e_l]
                        worst = [max(worst[0], e_v), max(worst[1], e_l),
                                 max(worst[2], e_i)]
                        every.append(torch.cat([v, (i + r * n).float(), l],
                                               -1))
                    mv, mi, ml = merge_candidates(torch.stack(every), k)
                    torch.cuda.synchronize()
                    ids_ok = bool(torch.equal(mi, want[1].long()))
                    vals_ok = bool(torch.equal(mv, want[0]))
                    rel = ((ml - want[2]).abs() / want[2].abs()).max().item()
                    check(ids_ok and vals_ok and rel <= 1e-6,
                          f"band_topk_lse shard {name} N={N} k={k} m={m}"
                          f" merged: ids {ids_ok}, values {vals_ok}, lse"
                          f" {rel:.3g} against the whole kernel")
            if N == 16:
                rows, n = rows_of[2][0], words // 2
                v, i, l = got[2, 1][0]
                t = time_ms(lambda: band.band_topk_lse(x, rows, 1, n))
                times[f"{name} m=2 rank0"] = t
                times[f"{name} whole"] = time_ms(
                    lambda: band.band_topk_lse(x, table, 1, words))
                line = tally.add(
                    (x, rows, v, i, l), 2.0 * N * rows.shape[0] * D, t,
                    time_ms(lambda: band.band_topk_lse_plain(x, rows, 1, n)),
                    time_ms(lambda: library_band(torch, x, rows, n)),
                    calls=1)
                print(f"    time band_topk_lse shard {name} m=2 rank 0:"
                      f" {line}")
            print(f"  band_topk_lse {name} ({V} rows, {words} selectable)"
                  f" N={N}, k = 1 / 5, over 2 and 4 ranks' rows: every rank"
                  f" against its plain twin values {worst[0]:.3g}, lse"
                  f" {worst[1]:.3g}, plain logit at chosen ids"
                  f" {worst[2]:.3g} (phase 3's tolerances); merged, ids and"
                  f" values equal to the whole kernel's, lse within 1e-6"
                  f" relative", flush=True)
        print(f"  band_topk_lse {name}: rank 0 (m=2)"
              f" {times[f'{name} m=2 rank0']:.4f} ms against the whole"
              f" {times[f'{name} whole']:.4f} ms", flush=True)
    return times


def shard_attention(torch, xattn, tally, launches) -> dict:
    """25.4. `decode_cross_attention` over each rank's 16/m heads of 64
    (m = 2, 4) at B = 16, Q = 1 (greedy) and 5 (beam), S' = 514 and 51:
    every rank's output against `decode_cross_attention_plain` on its
    inputs at phase 3's tolerance (0.02 abs + rel; the errors go into
    `tally`), and against the whole launch's head slice at the same
    tolerance. The ranks' launches are counted into `launches`. Rank 0's
    form at m = 2, Q = 1 is timed and tallied (4 layers of a greedy
    step, both contexts)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(28)
    B, E, H = 16, 1024, 16

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(torch.bfloat16)

    times = {}
    for S in (514, 51):
        k, v = rn(B, S, E), rn(B, S, E)
        bias = torch.zeros(B, S, device=dev)
        bias[B // 2:, S // 2:] = -1e9
        for Q in (1, 5):
            q = rn(B, Q, E, scale=0.125)
            ins = {m: [tuple(shard_cols(t, r, H // m * 64) for t in (q, k, v))
                       for r in range(m)] for m in (2, 4)}
            outs, counts = shard_window(
                torch, {"decode_cross_attention_shard":
                        xattn.decode_cross_attention},
                lambda: {m: [xattn.decode_cross_attention(qs, ks, vs, bias,
                                                          H // m)
                             for qs, ks, vs in ins[m]] for m in (2, 4)})
            add_counts(launches, counts)
            whole = xattn.decode_cross_attention(q, k, v, bias, H)
            for m in (2, 4):
                n = H // m
                worst = [0.0, 0.0]
                for r, ((qs, ks, vs), got) in enumerate(zip(ins[m],
                                                            outs[m])):
                    e, ok = within(got, xattn.decode_cross_attention_plain(
                        qs, ks, vs, bias, n), 0.02, 0.02)
                    check(ok, f"decode attention shard S'={S} Q={Q} m={m}"
                          f" rank {r} disagrees with its plain twin")
                    tally.errs.append(e)
                    e_w, ok_w = within(got, shard_cols(whole, r, n * 64),
                                       0.02, 0.02)
                    check(ok_w, f"decode attention shard S'={S} Q={Q}"
                          f" m={m} rank {r} disagrees with the whole launch")
                    worst = [max(worst[0], e), max(worst[1], e_w)]
                if m == 2 and Q == 1:
                    qs, ks, vs = ins[m][0]
                    t = time_ms(lambda: xattn.decode_cross_attention(
                        qs, ks, vs, bias, n))
                    times[f"S={S} m=2 rank0"] = t
                    times[f"S={S} whole"] = time_ms(
                        lambda: xattn.decode_cross_attention(q, k, v, bias,
                                                             H))
                    line = tally.add(
                        (qs, ks, vs, bias, outs[m][0]),
                        4.0 * B * Q * S * n * 64, t,
                        time_ms(lambda: xattn.decode_cross_attention_plain(
                            qs, ks, vs, bias, n)),
                        time_ms(lambda: sdpa(torch, qs, ks, vs, bias, n)),
                        calls=4)
                    print(f"    time decode_cross_attention shard S'={S}"
                          f" m=2 rank 0: {line}")
                print(f"  decode_cross_attention S'={S} Q={Q} {n} heads"
                      f" (m={m}): every rank against its plain twin"
                      f" {worst[0]:.3g}, against the whole launch's heads"
                      f" {worst[1]:.3g} (tol 0.02 + 0.02|ref|)", flush=True)
    return times


def split_decode(torch, counted):
    """25.5. Phase 4's flagship (seed 0, bf16) split over a `model` axis
    of one (`shard_params` over `make_mesh({data: 1, model: 1})`): greedy
    on phase 4's B=16 job and beam-5 at B=16 through the split code,
    where every form is the unsplit call (the FFN too: its whole
    kernel); tokens and scores equal to the unsplit model's. Returns
    ({kernel: launches} of the split runs, tokens equal)."""
    from news_image_caption_tpu_torch.parallel import distributed as pdist
    from news_image_caption_tpu_torch.parallel.mesh import (MeshConfig,
                                                            make_mesh)
    from news_image_caption_tpu_torch.parallel.partition import shard_params
    from news_image_caption_tpu_torch.serving.worker import \
        flagship_model_builder
    predict = flagship_model_builder("cuda", batch_size=1, max_len=32,
                                     early_exit=True, seed=0)
    model, cfg = predict.model, predict.config
    rng = np.random.RandomState(0)
    jobs = [make_job(rng, 1, [512]), make_job(rng, 1, [300]),
            make_job(rng, 1, [40]),
            make_job(rng, 16, rng.randint(20, 513, size=16))]
    batch = stage_batch(torch, jobs[-1], "cuda")
    bcfg = dataclasses.replace(cfg, beam_size=5)
    greedy, _ = model.generate(batch, cfg, predict.weights)
    beam, beam_scores = model.generate_beam(batch, bcfg, predict.weights)
    pdist.ensure_world("cuda")
    try:
        mesh = make_mesh(MeshConfig(data=1, model=1), "cuda")
        splits = shard_params(model.decoder, mesh)
        weights = model.decode_weights()
        for fn in counted.values():
            fn.launches = 0
        s_greedy, _ = model.generate(batch, cfg, weights)
        s_beam, s_scores = model.generate_beam(batch, bcfg, weights)
        torch.cuda.synchronize()
        launches = {n: fn.launches for n, fn in counted.items()}
    finally:
        pdist.shutdown()
    same = {"greedy": bool(torch.equal(s_greedy, greedy)),
            "beam5": bool(torch.equal(s_beam, beam)),
            "beam5_scores": bool(torch.equal(s_scores, beam_scores))}
    print(f"  phase 4's flagship split over a model axis of one ({len(splits)}"
          f" split parameters): greedy B=16 and beam-5 B=16 tokens equal to"
          f" the unsplit model's {same}; split-path launches {launches}",
          flush=True)
    check(all(same.values()), "the split decode at a model axis of one"
          " differs from the unsplit decode")
    check(all(n > 0 for n in launches.values()),
          f"the split decode skipped a kernel: {launches}")
    return launches, same


# The shard forms' entries of the `kernels` line: (the whole kernel,
# what the timed form holds). Their times are rank 0's at m = 2 over
# one step's calls. The flagship refuses a model axis above one (its
# 30265-row band), and one card runs one rank, so no entry point runs a
# shard form on the card: their launches are phase 25's own calls, every
# rank of m = 2 and 4, counted in the wrappers (`shard_window`).
SHARD_OF = {
    "flash_attention_fwd_shard": ("flash_attention_fwd",
                                  "heads [0, 8) of 16, h0 = 0 (m = 2)"),
    "flash_attention_bwd_shard": ("flash_attention_bwd",
                                  "heads [0, 8) of 16, h0 = 0 (m = 2)"),
    "decode_ffn_block_partial": ("decode_ffn_block",
                                 "columns [0, 2048) of F = 4096 (m = 2),"
                                 " fp32 partial"),
    "band_topk_lse_shard": ("band_topk_lse",
                            "rows [0, 2500) of the head band with its class"
                            " rows and [0, 7500) of band 1 (m = 2)"),
    "decode_cross_attention_shard": ("decode_cross_attention",
                                     "heads [0, 8) of 16 (m = 2)"),
}


def tensor_parallel_phase(torch, ops, counted, mesh_summary):
    """Phase 25. The shard forms of the flash, FFN, band top-k and decode
    attention kernels at the flagship's layer widths, for every rank of
    m = 2 and 4 in this one process, against their plain versions and
    their whole launches (25.1-25.4; the flagship's 30265-row band
    refuses m = 2 and 4 as the reference does), and the main path
    through the split code at a model axis of one: phase 24's train
    commands (records bit for bit phase 8's) and phase 4's model
    decoding greedy and beam-5 at B=16 (25.5). Returns ({path: {kernel:
    launches}}, {shard entry: Tally result}, {shard entry: launches of
    the ranks' calls}, summary)."""
    from news_image_caption_tpu_torch.config import build_model, load_config
    from news_image_caption_tpu_torch.parallel.partition import (ModelShard,
                                                                 shard_params)
    band, xattn, blocks, flash = ops
    tallies = {name: Tally() for name in SHARD_OF}
    shard_launches = {}
    summary = {"card": card_line()}
    summary["flash_ms"] = shard_flash(torch, flash, tallies, shard_launches)
    summary["ffn_ms"] = shard_ffn(torch, blocks,
                                  tallies["decode_ffn_block_partial"],
                                  shard_launches)
    summary["band_ms"] = shard_band(torch, band,
                                    tallies["band_topk_lse_shard"],
                                    shard_launches)
    decoder = build_model(load_config(EVAL_CONFIG), "meta").decoder
    refused = {}
    for m in (2, 4):
        try:
            shard_params(decoder, ModelShard(0, m))
            refused[m] = ""
        except ValueError as e:
            refused[m] = str(e)
        check("embedder.adaptive.embed_2" in refused[m]
              and "30265" in refused[m],
              f"the flagship at model {m} did not refuse its last band:"
              f" {refused[m]!r}")
    print(f"  the flagship at model 2 / 4: {refused[2]!r} / ...",
          flush=True)
    summary["attention_ms"] = shard_attention(
        torch, xattn, tallies["decode_cross_attention_shard"],
        shard_launches)
    launches, same = split_decode(torch, counted)
    summary["split_decode_equal"] = same
    summary["train_command_split_at_one"] = mesh_summary[
        "records_equal_phase8"]
    summary["shard_launches"] = shard_launches
    print(f"  times (ms, CUDA events, L2-cold, mean of 20) on {card_line()}:"
          f" {json.dumps({k: summary[k] for k in ('flash_ms', 'ffn_ms', 'band_ms', 'attention_ms')})}",
          flush=True)
    return ({"split_decode": launches},
            {name: t.result() for name, t in tallies.items()},
            shard_launches, summary)


def host_profile(path: str) -> dict:
    """A train-step window of a `torch.profiler` trace, on the host's
    clock: each `train_step.*` span's summed ms; the top-level operators
    (an operator inside no other on its thread) summed by name, ms and
    calls; the window's wall ms (first span start to last span end), the
    device's busy ms (the union of its kernels) and the number of
    operators of every depth."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"].startswith("train_step.")]
    start = min(e["ts"] for e in spans)
    end = max(e["ts"] + e["dur"] for e in spans)
    span_ms = {}
    for e in spans:
        span_ms[e["name"]] = span_ms.get(e["name"], 0.0) + e["dur"] / 1e3
    ops = sorted((e for e in events if e.get("cat") == "cpu_op"
                  and start <= e["ts"] <= end),
                 key=lambda e: (e["tid"], e["ts"], -e["dur"]))
    top, open_until = {}, {}
    for e in ops:
        if e["ts"] < open_until.get(e["tid"], -1):
            continue
        open_until[e["tid"]] = e["ts"] + e["dur"]
        ms, n = top.get(e["name"], (0.0, 0))
        top[e["name"]] = (ms + e["dur"] / 1e3, n + 1)
    busy, reach = 0.0, start
    for e in sorted((e for e in events if e.get("cat") == "kernel"
                     and start <= e["ts"] <= end), key=lambda e: e["ts"]):
        lo, hi = max(e["ts"], reach), e["ts"] + e["dur"]
        if hi > lo:
            busy += hi - lo
            reach = hi
    return {"wall_ms": (end - start) / 1e3, "device_busy_ms": busy / 1e3,
            "spans_ms": span_ms, "top_ops": top, "ops": len(ops)}


MESH_OVERHEAD = {"train_size": 320, "profile_start": 6, "profile_steps": 5}


def process_state(torch) -> dict:
    """This process's threads, objects the garbage collector tracks,
    resident memory (MiB) and the card's allocated memory (MiB)."""
    import gc
    with open("/proc/self/status") as f:
        rss = next(int(line.split()[1]) for line in f
                   if line.startswith("VmRSS:"))
    return {"threads": len(os.listdir("/proc/self/task")),
            "gc_objects": len(gc.get_objects()), "rss_mib": rss / 1024,
            "cuda_mib": torch.cuda.memory_allocated() / 2 ** 20}


def mesh_overhead_mode(torch, order: str = "pmpm") -> None:
    """`--mesh-overhead [ORDER]`: the train command on phase 8's YAML and
    cuts (bf16_o2, flash, B=16) at 320 records (20 steps, one epoch, the
    single-file store), without (`p`, plain) and with
    `trainer.distributed` and `trainer.mesh: {data: -1, model: 1}` (`m`,
    mesh, one NCCL rank), in ORDER's order in one process (default
    pmpm): each run's step seconds (host clock), their median past step
    0, the seconds the garbage collector took during the run and the
    process's state after it (`process_state`). Then one run of each
    with the profiler over steps [6, 11): per step, the spans' host ms,
    the top-level operators' ms (the 16 names whose time differs most
    between the two), the window's wall and the device's busy ms.
    Prints one `mesh_overhead` JSON line, also written to
    chiprun_out/mesh_overhead.json."""
    import gc
    import glob
    import tempfile

    from news_image_caption_tpu_torch import cli

    cfg = MESH_OVERHEAD
    steps = cfg["train_size"] // 16

    def run(mesh: bool, out_dir: str, **trainer):
        over = train_command_overrides(out_dir)
        over["dataset"]["train"]["size"] = cfg["train_size"]
        over["dataset"]["val"]["size"] = 16
        over["trainer"].update(num_epochs=1, log_every=steps,
                               num_serialized_models_to_keep=1,
                               summary_interval=0, **trainer)
        if mesh:
            over["trainer"].update(
                distributed={"coordinator_address":
                             f"127.0.0.1:{free_port()}",
                             "num_processes": 1, "process_id": 0},
                mesh={"data": -1, "model": 1})
        timings = {}
        rc = cli.main(["train", EVAL_CONFIG, "-o", json.dumps(over)],
                      timings=timings)
        check(rc == 0, f"train (mesh {mesh}) returned {rc}")
        step_s = timings["step_s"]
        check(len(step_s) == steps, f"{len(step_s)} steps, expected {steps}")
        return step_s

    check(order and set(order) <= {"p", "m"},
          f"--mesh-overhead {order!r}: a string of p (plain) and m (mesh)")
    gc_s, gc_start = [0.0], [0.0]

    def gc_clock(phase, info):
        if phase == "start":
            gc_start[0] = time.perf_counter()
        else:
            gc_s[0] += time.perf_counter() - gc_start[0]

    out = {"config": {**cfg, "order": order}, "card": card_line(),
           "runs": [], "profiles": {}}
    gc.callbacks.append(gc_clock)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for i, which in enumerate(order):
                name = "mesh" if which == "m" else "plain"
                gc_s[0] = 0.0
                step_s = run(which == "m", f"{tmp}/run{i}")
                rest = sorted(step_s[1:])
                out["runs"].append({
                    "run": name, "step0_ms": step_s[0] * 1e3,
                    "median_ms": rest[len(rest) // 2] * 1e3,
                    "step_ms": [t * 1e3 for t in step_s],
                    "gc_s": gc_s[0], **process_state(torch)})
                shutil.rmtree(f"{tmp}/run{i}")
                print(f"  run {i} {name}: step 0 {step_s[0] * 1e3:.2f} ms,"
                      f" median of steps 1-{steps - 1}"
                      f" {rest[len(rest) // 2] * 1e3:.2f} ms; after it "
                      + json.dumps({k: out["runs"][-1][k] for k in (
                          "gc_s", "threads", "gc_objects", "rss_mib",
                          "cuda_mib")}), flush=True)
            n = cfg["profile_steps"]
            for mesh in (False, True):
                name = "mesh" if mesh else "plain"
                out_dir = f"{tmp}/profiled_{name}"
                run(mesh, out_dir, profile_start=cfg["profile_start"],
                    profile_steps=n)
                traces = glob.glob(f"{out_dir}/profile/*.pt.trace.json")
                check(len(traces) == 1, f"profile directory holds {traces}")
                prof = host_profile(traces[0])
                check(prof["spans_ms"].get("train_step.forward") is not None,
                      f"no train step spans in {traces[0]}")
                out["profiles"][name] = prof
    finally:
        gc.callbacks.remove(gc_clock)
    plain, mesh = out["profiles"]["plain"], out["profiles"]["mesh"]
    names = set(plain["top_ops"]) | set(mesh["top_ops"])

    def per_step(prof, k):
        return prof["top_ops"].get(k, (0.0, 0))[0] / n

    diff = sorted(names, key=lambda k: -abs(per_step(mesh, k)
                                            - per_step(plain, k)))[:16]
    for name, prof in out["profiles"].items():
        top_ms = sum(ms for ms, _ in prof["top_ops"].values())
        print(f"  profiled {name}, per step: wall {prof['wall_ms'] / n:.2f}"
              f" ms, device busy {prof['device_busy_ms'] / n:.2f} ms,"
              f" top-level operators {top_ms / n:.2f} ms"
              f" ({prof['ops'] / n:.0f} operators of any depth); spans "
              + json.dumps({k: round(v / n, 3)
                            for k, v in prof["spans_ms"].items()}),
              flush=True)
    print("  top-level operators whose host ms a step differ most (plain,"
          " mesh): " + "; ".join(
              f"{k} {per_step(plain, k):.3f} / {per_step(mesh, k):.3f}"
              for k in diff), flush=True)
    out["largest_differences"] = {k: (per_step(plain, k), per_step(mesh, k))
                                  for k in diff}
    for prof in out["profiles"].values():
        prof["top_ops"] = {k: v for k, v in sorted(
            prof["top_ops"].items(), key=lambda kv: -kv[1][0])[:40]}
    line = json.dumps({"mesh_overhead": out})
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/mesh_overhead.json", "w") as f:
        f.write(line + "\n")
    print(line, flush=True)


# -- phase 26: the generic decode kernels ---------------------------------

GENERIC_OF = {"band_topk_lse_generic": "band_topk_lse",
              "decode_cross_attention_generic": "decode_cross_attention",
              "decode_conv_block_generic": "decode_conv_block",
              "decode_ffn_block_generic": "decode_ffn_block",
              # Phase 27's: the flash kernels' and the int8 variants'.
              "flash_attention_fwd_generic": "flash_attention_fwd",
              "flash_attention_bwd_generic": "flash_attention_bwd",
              "band_topk_lse_int8_generic": "band_topk_lse_int8",
              "decode_cross_attention_int8_generic":
                  "decode_cross_attention_int8"}
# The decode kernels' four (phase 26) and phase 27's four.
DECODE_GENERIC = tuple(GENERIC_OF)[:4]
GENERIC27 = tuple(GENERIC_OF)[4:]
# fp32 against the fp32 plain version: the sums differ in order only.
FP32_TOL = (1e-5, 1e-5)
# The redesigned generic kernels' times before their redesign (PERF.md
# §6, from this script's calls on an H100 80GB HBM3 at 700.00 W): ms a
# fp32 flagship train step (the flash forward) or greedy and beam-5 step
# at B=16 (the attentions, the conv block and the FFN).
WAS_MS = {"flash_attention_fwd_generic": {"train step": 1.0425},
          "decode_cross_attention_generic": {"greedy": 0.6618,
                                             "beam-5": 0.7260},
          "decode_cross_attention_int8_generic": {"greedy": 0.6790,
                                                  "beam-5": 0.7389},
          "decode_conv_block_generic": {"greedy": 0.3747,
                                        "beam-5": 0.5467},
          "decode_ffn_block_generic": {"greedy": 0.1964,
                                       "beam-5": 0.5162}}
# Phase 26's redesigned kernels.
REDESIGNED26 = ("decode_cross_attention_generic", "decode_conv_block_generic",
                "decode_ffn_block_generic")


def print_redesigned(name: str, results: dict) -> dict:
    """A line for each step of a redesigned kernel: its time beside its
    plain version's, the library call's, its bound and its time before
    the redesign (WAS_MS). Returns {step: the numbers}."""
    out = {}
    for step, r in results.items():
        was, lib = WAS_MS[name][step], r["library_ms"]
        print(f"  redesigned {name}, {step}: kernel {r['ms']:.4f} ms (was"
              f" {was:.4f}), plain {r['plain_ms']:.4f} ms, library"
              f" {lib:.4f} ms, bound {r['bound_ms']:.4f} ms"
              f" ({r['bound_by']}); the library's time over the kernel's"
              f" {lib / r['ms']:.2f}", flush=True)
        out[step] = dict(ms=r["ms"], was_ms=was, plain_ms=r["plain_ms"],
                         library_ms=lib, bound_ms=r["bound_ms"])
    return out


def generic_counted() -> dict:
    """The eight generic variants' wrappers, by their kernels-line name
    (each counts its launches in `.launches`)."""
    from news_image_caption_tpu_torch.ops import (band_topk,
                                                  decode_attention,
                                                  decode_blocks,
                                                  flash_attention)
    return {"band_topk_lse_generic": band_topk.band_topk_lse_generic,
            "decode_cross_attention_generic":
                decode_attention.decode_cross_attention_generic,
            "decode_conv_block_generic":
                decode_blocks.decode_conv_block_generic,
            "decode_ffn_block_generic": decode_blocks.decode_ffn_block_generic,
            "flash_attention_fwd_generic":
                flash_attention.flash_attention_fwd_generic,
            "flash_attention_bwd_generic":
                flash_attention.flash_attention_bwd_generic,
            "band_topk_lse_int8_generic":
                band_topk.band_topk_lse_int8_generic,
            "decode_cross_attention_int8_generic":
                decode_attention.decode_cross_attention_int8_generic}


def no_generic(phase: str, names=tuple(GENERIC_OF)) -> None:
    """Phases 3 to 25 run the flagship's widths in bf16, where every
    wrapper routes "fast": no generic variant of `names` may have
    launched since the first phase (phase 26 resets its four only)."""
    n = {name: fn.launches for name, fn in generic_counted().items()
         if name in names}
    check(not any(n.values()),
          f"phase {phase} launched a generic variant: {n}")


def generic_kernel_phase(torch, ops):
    """Phase 26.1. Each generic variant against its plain version on the
    card (TF32 off), second calls bit-equal: the toy's shapes in fp32 and
    tiny_test's in bf16 (embed 32 / 16, 4 heads, ffn 64 / 32, bands of
    18 / 16 / 32 ids, S' of 5 to 18 keys), pointwise layers (K = 1, at
    toy and flagship width), other odd widths, and the fp32 flagship's
    greedy step (16 rows, Q = 1) and beam-5 step (80 rows, Q = 5) at
    B=16. Tolerances: fp32 1e-5 + 1e-5 |ref|; bf16 phase 3's (band
    values 0.03125, lse 1e-3 + 1e-4 |lse|, attention 0.02 + 0.02 |ref|,
    conv h 0.02 and y 0.05, FFN 0.02), the FFN's fp32 partial sums of
    bf16 rows phase 25's 2e-3 + 1e-3 |ref|. The fp32 flagship's calls
    are timed beside their plain versions and the library chains in fp32
    (fp32 rate and bytes in the bound). Returns ({kernel: result} of the
    greedy step, the same of the beam-5 step, the worst error a kernel
    over all cases)."""
    band, xattn, blocks = ops
    F_ = torch.nn.functional
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(26)
    f32, bf16 = torch.float32, torch.bfloat16
    greedy = {name: Tally("fp32") for name in DECODE_GENERIC}
    beam = {name: Tally("fp32") for name in DECODE_GENERIC}
    worst = dict.fromkeys(DECODE_GENERIC, 0.0)

    def rn(dtype, *shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(dtype)

    def tol(dtype, bf):
        return FP32_TOL if dtype == f32 else bf

    def note(name, what, errs, oks, same, line=""):
        worst[name] = max(worst[name], *errs)
        print(f"  {name} {what}: errors {', '.join(f'{e:.3g}' for e in errs)}"
              f"{line}, repeated call bit-equal {same}", flush=True)
        check(all(oks), f"{name} {what} disagrees with its plain version")
        check(same, f"{name} {what}: two calls on the same inputs differ")

    def band_case(dtype, N, D, V, sel, k, tally=None):
        x, table = rn(dtype, N, D), rn(dtype, V, D, scale=D ** -0.5)
        got = band.band_topk_lse_generic(x, table, k, sel)
        again = band.band_topk_lse_generic(x, table, k, sel)
        want = band.band_topk_lse_plain(x, table, k, sel)
        torch.cuda.synchronize()
        logits = (x.float() @ table.float().T).to(dtype).float()
        tv = tol(dtype, (0.03125, 0.0))
        e_v, ok_v = within(got[0], want[0], *tv)
        e_l, ok_l = within(got[2], want[2], *tol(dtype, (1e-3, 1e-4)))
        e_i, ok_i = within(torch.gather(logits, 1, got[1].long()), want[0],
                           *tv)
        ok_ids = bool((got[1] >= 0).all()) and bool((got[1] < sel).all())
        agree = (got[1] == want[1]).float().mean().item()
        note("band_topk_lse_generic",
             f"{str(dtype)[6:]} N={N} D={D} V={V} sel={sel} k={k}",
             [e_v, e_l, e_i], [ok_v, ok_l, ok_i, ok_ids],
             all(torch.equal(a, b) for a, b in zip(got, again)),
             f" (values / lse / plain logit at the chosen ids), ids equal"
             f" {agree:.3f}")
        if tally is None:
            return
        tally.errs += [e_v, e_l]

        def library():
            lg = x @ table.T
            return torch.logsumexp(lg, -1), torch.topk(lg[:, :sel], k)
        line = tally.add(
            (x, table, *got), 2.0 * N * V * D,
            time_ms(lambda: band.band_topk_lse_generic(x, table, k, sel)),
            time_ms(lambda: band.band_topk_lse_plain(x, table, k, sel)),
            time_ms(library))
        print(f"    time: {line}", flush=True)

    def attn_case(dtype, B, Q, S, E, H, tally=None, calls=1, one_key=False):
        q = rn(dtype, B, Q, E, scale=(E // H) ** -0.5)
        k_, v_ = rn(dtype, B, S, E), rn(dtype, B, S, E)
        bias = torch.zeros(B, S, device=dev)
        bias[B // 2:, S // 2:S - 1] = -1e9
        if one_key:
            bias[0] = -1e9
            bias[0, S // 3] = 0.0
        args = (q, k_, v_, bias, H)
        got = xattn.decode_cross_attention_generic(*args)
        again = xattn.decode_cross_attention_generic(*args)
        want = xattn.decode_cross_attention_plain(*args)
        torch.cuda.synchronize()
        e, ok = within(got, want, *tol(dtype, (0.02, 0.02)))
        note("decode_cross_attention_generic",
             f"{str(dtype)[6:]} B={B} Q={Q} S'={S} E={E} H={H}"
             + (" (item 0: one key)" if one_key else ""), [e], [ok],
             bool(torch.equal(got, again)))
        if tally is None:
            return
        tally.errs.append(e)
        line = tally.add(
            (q, k_, v_, bias, got), 4.0 * B * Q * S * E,
            time_ms(lambda: xattn.decode_cross_attention_generic(*args)),
            time_ms(lambda: xattn.decode_cross_attention_plain(*args)),
            time_ms(lambda: sdpa(torch, q, k_, v_, bias, H)), calls=calls)
        print(f"    time, {calls} calls: {line}", flush=True)

    def conv_case(dtype, N, C, H, K, ts, tally=None, rows_pos=False):
        x, cache = rn(dtype, N, C), rn(dtype, K - 1, N, C, scale=0.5)
        w1, b1 = rn(dtype, C, 2 * C, scale=C ** -0.5), rn(dtype, 2 * C,
                                                          scale=0.05)
        wl = rn(dtype, C, H * K, scale=0.05 if dtype == bf16 else 0.3)
        w2, b2 = rn(dtype, C, C, scale=C ** -0.5), rn(dtype, C, scale=0.05)
        taps = blocks.pack_taps(wl, H)
        errs, oks, same = [0.0, 0.0], [], True
        steps = [torch.randint(0, 3 * K + 3, (N,), generator=gen, device=dev,
                               dtype=torch.int32)] if rows_pos else ts
        for t in steps:
            args = (x, cache, t, w1, b1, wl, w2, b2, H)
            y, h = blocks.decode_conv_block_generic(*args, taps=taps)
            y2, h2 = blocks.decode_conv_block_generic(*args, taps=taps)
            py, ph = blocks.decode_conv_block_plain(*args)
            torch.cuda.synchronize()
            e_h, ok_h = within(h, ph, *tol(dtype, (0.02, 0.02)))
            e_y, ok_y = within(y, py, *tol(dtype, (0.05, 0.05)))
            errs = [max(errs[0], e_h), max(errs[1], e_y)]
            oks += [ok_h, ok_y]
            same = same and bool(torch.equal(y, y2)) and bool(
                torch.equal(h, h2))
        note("decode_conv_block_generic",
             f"{str(dtype)[6:]} N={N} C={C} H={H} K={K} t="
             + ("a position a row" if rows_pos else "/".join(map(str, ts))),
             errs, oks, same, " (h / y)")
        if tally is None:
            return
        tally.errs += errs
        slots = (ts[-1] + torch.arange(K - 1, device=dev)) % max(K - 1, 1)

        def library():
            hh = F_.glu(F_.linear(x, w1.T, b1), dim=-1)
            p = torch.softmax(F_.linear(hh, wl.T).view(N, H, K), dim=-1)
            hist = torch.cat([cache[slots], hh[None]]).view(K, N, H, C // H)
            conv = torch.einsum("nhk,knhr->nhr", p, hist).reshape(N, C)
            return F_.linear(conv, w2.T, b2) + x, hh
        line = tally.add(
            (x, cache, w1, b1, wl, w2, b2, y, h),
            2.0 * N * C * (2 * C + H * K + C) + 2.0 * N * C * K,
            time_ms(lambda: blocks.decode_conv_block_generic(*args,
                                                             taps=taps)),
            time_ms(lambda: blocks.decode_conv_block_plain(*args)),
            time_ms(library))
        print(f"    time K={K}: {line}", flush=True)

    def ffn_case(dtype, N, C, F, tally=None, calls=1, partial=False):
        x, w1, b1 = rn(dtype, N, C), rn(dtype, C, F, scale=C ** -0.5), \
            rn(dtype, F, scale=0.05)
        w2, b2 = rn(dtype, F, C, scale=F ** -0.5), rn(dtype, C, scale=0.05)
        if partial:
            args = (x, w1, b1, w2, None)
            want = blocks.decode_ffn_block_partial_plain(x, w1, b1, w2)
            t = tol(dtype, PARTIAL_TOL)
        else:
            args = (x, w1, b1, w2, b2)
            want = blocks.decode_ffn_block_plain(*args)
            t = tol(dtype, (0.02, 0.02))
        got = blocks.decode_ffn_block_generic(*args)
        again = blocks.decode_ffn_block_generic(*args)
        torch.cuda.synchronize()
        e, ok = within(got, want, *t)
        note("decode_ffn_block_generic",
             f"{str(dtype)[6:]} N={N} C={C} F={F}"
             + (" (partial mode)" if partial else ""), [e], [ok],
             bool(torch.equal(got, again)))
        if tally is None:
            return
        tally.errs.append(e)
        line = tally.add(
            (x, w1, b1, w2, b2, got), 4.0 * N * C * F,
            time_ms(lambda: blocks.decode_ffn_block_generic(*args)),
            time_ms(lambda: blocks.decode_ffn_block_plain(*args)),
            time_ms(lambda: F_.linear(torch.relu(F_.linear(x, w1.T, b1)),
                                      w2.T, b2) + x), calls=calls)
        print(f"    time, {calls} calls: {line}", flush=True)

    # The toy's shapes in fp32 and tiny_test's in bf16: embed 32 / 16,
    # 4 heads, ffn 64 / 32; the bands [table0; class rows] (18 ids, 16
    # selectable) and the tails (16, 32); one row (B = 1) and five (a
    # beam-5 step); image and article contexts plus the bias and zero
    # slots (S' = 5 to 18); a chunk of 4 queries.
    for dtype, D, F in ((f32, 32, 64), (bf16, 16, 32)):
        for N in (1, 5):
            for V, sel in ((18, 16), (16, 16), (32, 32)):
                for k in (1, 5, 16):
                    band_case(dtype, N, D, V, sel, min(k, sel))
            ffn_case(dtype, N, D, F)
            ffn_case(dtype, N, D, F, partial=True)
            for K in (3, 5):
                conv_case(dtype, N, D, 4, K, (0, K - 2, 2 * K + 3))
            conv_case(dtype, N, D, 4, 5, None, rows_pos=True)
        for Q in (1, 4, 5):
            for S in (5, 6, 8, 18):
                attn_case(dtype, 1 if Q == 1 else 2, Q, S, D, 4)
        attn_case(dtype, 3, 1, 6, D, 4, one_key=True)
    # Pointwise layers (K = 1: no ring, the cache empty) and other widths:
    # head sizes 1, 3 and 256, D and C off every tile, two row tiles.
    for dtype in (f32, bf16):
        conv_case(dtype, 5, 32, 4, 1, (0, 3))
        conv_case(dtype, 40, 48, 3, 32, (0, 40))
        attn_case(dtype, 2, 3, 7, 4, 4)
        attn_case(dtype, 2, 16, 70, 512, 2)
        attn_case(dtype, 3, 2, 33, 39, 13)
        band_case(dtype, 37, 100, 129, 129, 16)
        band_case(dtype, 3, 1, 5, 5, 5)
        ffn_case(dtype, 33, 100, 200)
    conv_case(f32, 16, 1024, 16, 1, (0, 9))
    conv_case(f32, 80, 1024, 16, 1, None, rows_pos=True)
    # The fp32 flagship: a greedy step at B=16 (16 rows, Q = 1; the three
    # bands at k = 1, K = 3 / 7 / 15 / 31, the image and article contexts
    # of every layer), timed; a beam-5 step at B=16 (80 rows, Q = 5,
    # k = 5), timed; 640 rows (beam-5 at B=128) held.
    N, D, H, F = 16, 1024, 16, 4096
    for V, sel in ((5002, 5000), (15000, 15000), (30265, 30265)):
        band_case(f32, N, D, V, sel, 1, greedy["band_topk_lse_generic"])
        band_case(f32, 5 * N, D, V, sel, 5, beam["band_topk_lse_generic"])
    band_case(f32, 640, D, 5002, 5000, 5)
    for S in (514, 51):
        attn_case(f32, N, 1, S, D, H, greedy[
            "decode_cross_attention_generic"], calls=4)
        attn_case(f32, N, 5, S, D, H, beam[
            "decode_cross_attention_generic"], calls=4)
    attn_case(f32, N, 5, 514, D, H, one_key=True)
    # The split plan's edges: S' of a split's 64 keys and one either
    # side, two splits' and one either side, 11 splits (heads of 1); heads
    # of 3 (rows off 16 bytes), 24 and 256; Q 1 to 16.
    for dtype in (f32, bf16):
        for S in (63, 64, 65, 127, 128, 129):
            attn_case(dtype, 3, 5, S, D, H)
        attn_case(dtype, 3, 16, 700, 16, 16)
        attn_case(dtype, 3, 3, 514, 96, 4)
        attn_case(dtype, 3, 16, 300, 256, 1)
        attn_case(dtype, 3, 2, 200, 39, 13)
    for K in (3, 7, 15, 31):
        conv_case(f32, N, D, H, K, (0, K - 2, 2 * K + 3),
                  greedy["decode_conv_block_generic"])
        conv_case(f32, 5 * N, D, H, K, (2 * K + 3,),
                  beam["decode_conv_block_generic"])
    conv_case(f32, 5 * N, D, H, 7, None, rows_pos=True)
    ffn_case(f32, N, D, F, greedy["decode_ffn_block_generic"], calls=4)
    ffn_case(f32, 5 * N, D, F, beam["decode_ffn_block_generic"], calls=4)
    ffn_case(f32, N, D, F, partial=True)
    ffn_case(f32, 640, D, F)
    # The products' plan edges (`generic_product_plan`): rows at the row
    # tiles' edges (16, 32, 80) and past them, K = 1 and 32 (the tap
    # logits' strips of whole heads), widths off every tile and chunk,
    # the partial mode past one row tile.
    for dtype in (f32, bf16):
        for rows in (1, 17, 32, 33, 81):
            ffn_case(dtype, rows, D, F)
        ffn_case(dtype, 81, 48, 200, partial=True)
        ffn_case(dtype, 33, 200, 48)
        conv_case(dtype, 1, D, H, 3, (0, 5))
        conv_case(dtype, 17, D, H, 32, (40,))
        conv_case(dtype, 33, D, H, 15, None, rows_pos=True)
        conv_case(dtype, 81, D, H, 31, (70,))
        conv_case(dtype, 640, D, H, 3, (2,))
        conv_case(dtype, 81, 200, 8, 1, (0,))
        conv_case(dtype, 5, 100, 4, 31, None, rows_pos=True)
    return ({n: t.result() for n, t in greedy.items()},
            {n: t.result() for n, t in beam.items()}, worst)


def plain_decode():
    """A context manager: the four decode wrappers and the two int8 ones,
    where the decoder's modules call them, swapped for their plain
    versions, so that a model decodes on the card through plain PyTorch
    (TF32 off): phases 26's and 27's yardstick for the kernel path on the
    same card and weights."""
    import contextlib

    from news_image_caption_tpu_torch.models import decoder_flattened
    from news_image_caption_tpu_torch.ops import (adaptive, attention,
                                                  band_topk, decode_attention,
                                                  decode_blocks)
    swaps = [(adaptive, "band_topk_lse", band_topk.band_topk_lse_plain),
             (attention, "decode_cross_attention",
              decode_attention.decode_cross_attention_plain),
             (adaptive, "band_topk_lse_int8",
              band_topk.band_topk_lse_int8_plain),
             (attention, "decode_cross_attention_int8",
              decode_attention.decode_cross_attention_int8_plain),
             (decoder_flattened, "decode_conv_block",
              lambda *a, taps=None: decode_blocks.decode_conv_block_plain(
                  *a)),
             (decoder_flattened, "decode_ffn_block",
              lambda *a, reduce=None: decode_blocks.decode_ffn_block_plain(
                  *a))]

    @contextlib.contextmanager
    def swapped():
        old = [getattr(mod, name) for mod, name, _ in swaps]
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        try:
            yield
        finally:
            for (mod, name, _), fn in zip(swaps, old):
                setattr(mod, name, fn)
    return swapped()


def token_ties(what: str, got, want, lp_got, lp_want, tol: float = 1e-5):
    """Greedy tokens [B, L + 1] of the kernel path against the plain
    path's. A row that differs must do so at a near-tie: at its first
    differing position the two paths' top-1 log-probs (each of its own
    token, after the same prefix) within `tol`, so the plain path's top
    two were that close. Returns the rows that differ at such a tie;
    fails on any other difference."""
    got, want = np.asarray(got), np.asarray(want)
    lp_got, lp_want = np.asarray(lp_got), np.asarray(lp_want)
    ties = []
    for row in np.flatnonzero((got != want).any(axis=1)):
        j = int(np.flatnonzero(got[row] != want[row])[0])
        gap = abs(float(lp_got[row, j - 1]) - float(lp_want[row, j - 1]))
        check(j >= 1 and gap <= tol,
              f"{what}: row {row} differs from the plain path at position"
              f" {j} with top-1 log-probs {gap:.3g} apart (not a tie within"
              f" {tol})")
        ties.append({"row": int(row), "position": j, "lp_gap": gap})
    print(f"  {what}: tokens equal to the plain path's on"
          f" {len(got) - len(ties)} of {len(got)} rows"
          + (f"; near-ties reported: {ties}" if ties else ""), flush=True)
    return ties


def generic_decode_phase(torch, counted, quantize: bool = False):
    """Phase 26.2. The flagship decoder in fp32 (seeded random weights,
    full width and depth) decoding greedy at B=16 and beam-5 at B=16 over
    32 steps on the card: every decode call through the generic variants
    (3 / 8 / 4 / 4 a step, the fast kernels none), tokens against the
    same model's plain path on the card (`plain_decode`). A greedy row
    may differ only at a near-tie (`token_ties`); a beam item only where
    its best scores agree within 1e-4, reported. quantize (phase 27.4):
    the same under quantize_kv and quantize_head (the int8 head tables
    made once, `decode_weights(quantize_head=True)`), the band's 3 and
    the attention's 8 calls a step through the int8 generic variants.
    Returns ({path: {kernel: launches}}, summary)."""
    from news_image_caption_tpu_torch.config import FLAGSHIP
    from news_image_caption_tpu_torch.generation.generator import \
        GenerationConfig
    from news_image_caption_tpu_torch.models.captioner import \
        TransformerFlattened
    dev = torch.device("cuda")
    model = TransformerFlattened(
        device=dev, dtype=torch.float32, **FLAGSHIP,
        generator=torch.Generator(device=dev).manual_seed(26))
    model.decoder.eval()
    rng = np.random.RandomState(26)
    job = make_job(rng, 16, rng.randint(20, 513, size=16))
    batch = {k: torch.as_tensor(v).to(dev) for k, v in job.items()}
    # The generic variant each decode call takes, launches a step.
    route = {"band_topk_lse": "band_topk_lse_generic",
             "decode_cross_attention": "decode_cross_attention_generic",
             "decode_conv_block": "decode_conv_block_generic",
             "decode_ffn_block": "decode_ffn_block_generic"}
    if quantize:
        route.update(band_topk_lse="band_topk_lse_int8_generic",
                     decode_cross_attention=(
                         "decode_cross_attention_int8_generic"))
    want = dict.fromkeys(counted, 0)
    for fast, n in greedy_launches_a_step().items():
        want[route[fast]] = n * 32
    tag = "fp32_int8" if quantize else "fp32"
    launches, summary = {}, {"card": card_line()}
    with torch.no_grad():
        weights = model.decoder.decode_weights(quantize_head=quantize)
        for path, beam in ((f"{tag}_greedy_b16", False),
                           (f"{tag}_beam5_b16", True)):
            cfg = GenerationConfig(max_len=32, early_exit=False, beam_size=5,
                                   quantize_kv=quantize,
                                   quantize_head=quantize)
            run = model.generate_beam if beam else model.generate
            run(batch, cfg, weights)                    # warm-up
            for fn in counted.values():
                fn.launches = 0
            torch.cuda.synchronize()
            t = time.perf_counter()
            tok, score = run(batch, cfg, weights)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            got = {name: fn.launches for name, fn in counted.items()}
            t = time.perf_counter()
            with plain_decode():
                ptok, pscore = run(batch, cfg, weights)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t) * 1e3
            check(got == want, f"{path}: launches {got}, expected {want}")
            launches[path] = {name: n for name, n in got.items() if n}
            tok, ptok = tok.cpu().numpy(), ptok.cpu().numpy()
            score, pscore = score.float().cpu().numpy(), \
                pscore.float().cpu().numpy()
            check(bool(np.isfinite(score).all()),
                  f"{path}: scores not finite")
            if not beam:
                ties = token_ties(path, tok, ptok, score, pscore)
            else:
                differ = np.flatnonzero((tok != ptok).reshape(16, -1).any(1))
                ties = [{"item": int(i), "best_score_gap": float(abs(
                    score[i, 0] - pscore[i, 0]))} for i in differ]
                check(all(x["best_score_gap"] <= 1e-4 for x in ties),
                      f"{path}: beams differ from the plain path's beyond a"
                      f" tie: {ties}")
                worst = float(np.abs(score - pscore).max())
                print(f"  {path}: tokens equal to the plain path's on"
                      f" {16 - len(ties)} of 16 items, scores within"
                      f" {worst:.3g}" + (f"; near-ties reported: {ties}"
                                          if ties else ""), flush=True)
            summary[path] = {"request_ms": ms, "plain_path_ms": plain_ms,
                             "ties": ties, "launches": launches[path]}
            print(f"  {path}: 32 steps in {ms:.1f} ms on the generic"
                  f" variants ({ms / 32:.3f} ms a step), {plain_ms:.1f} ms"
                  f" on the plain path; launches {launches[path]}",
                  flush=True)
    return launches, summary


TOY_SERVE_CMD = [sys.executable, "-m", "news_image_caption_tpu_torch.cli",
                 "serve", "--task", "toy", "--http-port", "0"]


def toy_jobs(n: int, seed: int = 26) -> list:
    """Requests of the toy's shapes (image 4 x 16, article 6 x 24), the
    last of three rows, articles padded at random."""
    from news_image_caption_tpu_torch.serving.worker import (
        TOY, TOY_ARTICLE_LEN, TOY_IMAGE_LEN)
    rng = np.random.RandomState(seed)
    jobs = []
    for i in range(n):
        B = 3 if i == n - 1 else 1
        lens = rng.randint(1, TOY_ARTICLE_LEN + 1, size=B)
        jobs.append({
            "image": rng.randn(B, TOY_IMAGE_LEN,
                               TOY["image_dim"]).astype(np.float32),
            "image_mask": np.zeros((B, TOY_IMAGE_LEN), bool),
            "article": rng.randn(B, TOY_ARTICLE_LEN,
                                 TOY["article_dim"]).astype(np.float32),
            "article_mask": np.arange(TOY_ARTICLE_LEN)[None, :]
            >= lens[:, None]})
    return jobs


def toy_serve_phase(torch, platforms=("cuda", "cpu")):
    """Phase 26.3. `serve --task toy` on the card (fp32, head size 8: the
    generic variants) and the same server with `--platform cpu`, started
    side by side, each answer five HTTP requests: tokens equal, or a
    near-tie (`token_ties`, the log-probs from the in-process builder on
    each device). The card's worker launches only generic variants (its
    stats RPC). Returns (the worker's launches, summary)."""
    import contextlib

    from news_image_caption_tpu_torch.serving.client import CaptioningClient
    from news_image_caption_tpu_torch.serving.worker import \
        default_model_builder
    jobs = toy_jobs(5)
    tokens, summary = {}, {"card": card_line()}
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        serves = {p: stack.enter_context(ServeProcess(
            TOY_SERVE_CMD + ["--platform", p])) for p in platforms}
        ready = {}
        for platform, serve in serves.items():
            info = json.loads(serve.next_line("stdout", 120))
            port = json.loads(serve.next_line("stdout", 60))["http_port"]
            check(info["task"] == "toy", f"serve printed {info}")
            serve.next_line("stderr", 300, match="worker 0 ready")
            ready[platform] = (info, port, time.perf_counter() - t0)
        for platform, serve in serves.items():
            info, port, ready_s = ready[platform]
            lat, got = [], []
            for job in jobs:
                t = time.perf_counter()
                got.append(http_encode(port, job))
                lat.append((time.perf_counter() - t) * 1e3)
            client = CaptioningClient(info["frontend_addr"],
                                      info["sink_pub_addr"],
                                      timeout_ms=300000)
            try:
                stats = client.stats(timeout_ms=60000)
            finally:
                client.close()
            rc, _ = serve.stop()
            check(rc == 0, f"serve --task toy --platform {platform} exited"
                  f" with {rc}")
            left = [p for p in serve.children if _alive(p)]
            check(not left, f"processes left after serve stopped: {left}")
            tokens[platform] = np.concatenate(got)
            summary[platform] = {"start_to_ready_s": ready_s,
                                 "request_ms": lat,
                                 "kernel_launches": stats["kernel_launches"]}
            print(f"  serve --task toy --platform {platform}: {len(jobs)}"
                  f" HTTP requests, ms {[round(x, 1) for x in lat]}, start"
                  f" to ready {ready_s:.1f} s", flush=True)
    worker = summary[platforms[0]]["kernel_launches"]
    check(all(worker[g] > 0 and worker[GENERIC_OF[g]] == 0
              for g in DECODE_GENERIC),
          f"the card's toy worker launched {worker}")
    check(not any(summary[platforms[1]]["kernel_launches"].values()),
          "the CPU's toy worker counted a launch")
    lps = {}
    for platform in platforms:
        predict = default_model_builder(platform)
        lps[platform] = np.concatenate([
            predict.model.generate(
                {k: torch.as_tensor(v).to(platform) for k, v in j.items()},
                predict.config, predict.weights)[1].float().cpu().numpy()
            for j in jobs])
    summary["ties"] = token_ties("serve --task toy, card against CPU",
                                 tokens[platforms[0]], tokens[platforms[1]],
                                 lps[platforms[0]], lps[platforms[1]])
    return {name: worker[name] for name in DECODE_GENERIC}, summary


def tiny_commands_phase(torch, counted):
    """Phase 26.4. `train configs/tiny_test.yaml` on the card (fp32, the
    config's 2 epochs), then `evaluate -m best` from its checkpoints, then
    `evaluate configs/tiny_pointer.yaml` (random init): the decodes in
    bf16 at embed 16, 4 heads of 4, ffn 32 go through the generic
    variants only; every command returns 0 with finite metrics. Returns
    ({path: {kernel: launches}}, summary)."""
    import math

    from news_image_caption_tpu_torch import cli
    launches, summary = {}, {}
    keys = ("bleu-1", "bleu-4", "cider", "rouge-l")
    with tempfile.TemporaryDirectory() as tmp:
        run, ev = f"{tmp}/run", f"{tmp}/pointer"
        t = time.perf_counter()
        rc = cli.main(["train", "configs/tiny_test.yaml", "-s", run])
        check(rc == 0, f"train configs/tiny_test.yaml returned {rc}")
        with open(f"{run}/metrics.jsonl") as f:
            records = [json.loads(line) for line in f]
        summary["train_s"] = time.perf_counter() - t
        summary["train_records"] = len(records)
        for path, argv, out in (
                ("tiny_test_evaluate",
                 ["evaluate", "configs/tiny_test.yaml", "-m", "best", "-o",
                  json.dumps({"trainer": {"serialization_dir": run}})], run),
                ("tiny_pointer_evaluate",
                 ["evaluate", "configs/tiny_pointer.yaml", "-o",
                  json.dumps({"trainer": {"serialization_dir": ev}})], ev)):
            for fn in counted.values():
                fn.launches = 0
            t = time.perf_counter()
            rc = cli.main(argv)
            wall = time.perf_counter() - t
            got = {name: fn.launches for name, fn in counted.items()}
            check(rc == 0, f"{' '.join(argv[:2])} returned {rc}")
            with open(f"{out}/evaluate-metrics.json") as f:
                metrics = json.load(f)
            check(metrics["n_samples"] == 8
                  and all(math.isfinite(metrics[k]) for k in keys),
                  f"{path}: metrics {metrics}")
            check(all(got[g] > 0 and got[GENERIC_OF[g]] == 0
                      for g in DECODE_GENERIC),
                  f"{path}: launches {got}")
            launches[path] = {name: n for name, n in got.items() if n}
            summary[path] = {"s": wall,
                             "metrics": {k: metrics[k] for k in keys},
                             "launches": launches[path]}
            print(f"  {' '.join(argv[:2])}: {wall:.1f} s, metrics"
                  f" { {k: round(metrics[k], 4) for k in keys} }, launches"
                  f" {launches[path]}", flush=True)
    print(f"  train configs/tiny_test.yaml on the card:"
          f" {summary['train_s']:.1f} s, {summary['train_records']}"
          " records", flush=True)
    return launches, summary


def generic_phase(torch, ops, counted):
    """Phase 26 (see the module): 26.1 the generic kernels against their
    plain versions, 26.2 the fp32 flagship's decodes, 26.3 the toy's
    serve command, 26.4 the tiny configs' commands. Returns ({path:
    {kernel: launches}}, the greedy and beam-5 step tallies of 26.1, the
    worst error a kernel, summary)."""
    gcounted = {n: fn for n, fn in generic_counted().items()
                if n in DECODE_GENERIC}
    counted = dict(counted, **gcounted)
    t = time.perf_counter()
    greedy, beam, worst = generic_kernel_phase(torch, ops)
    summary = {"kernels_s": time.perf_counter() - t, "redesigned": {
        name: print_redesigned(name, {"greedy": greedy[name],
                                      "beam-5": beam[name]})
        for name in REDESIGNED26}}
    launches, summary["fp32_flagship"] = generic_decode_phase(torch,
                                                              counted)
    launches["serve_toy"], summary["serve_toy"] = toy_serve_phase(torch)
    tiny_launches, summary["tiny_commands"] = tiny_commands_phase(torch,
                                                                  counted)
    launches.update(tiny_launches)
    summary["seconds"] = time.perf_counter() - t
    return launches, greedy, beam, worst, summary


# -- phase 27: generic flash kernels and the int8 generic variants ------

# fp32 flagship train command: the steps, and the first steps whose losses
# the plain flash path must give within 1e-5 relative.
FP32_TRAIN_STEPS, FP32_TRAIN_HELD = 8, 3


def flash_generic_case(torch, flash, what: str, q, k, v, g, bias, seed,
                       H: int, p: float, tallies=None, calls: int = 1):
    """The generic flash forward and backward at these inputs against
    their plain versions and a second call bit for bit: fp32 within
    1e-5 + 1e-5 |ref| (out, lse, dq, dk, dv), bf16 at phase 3's
    tolerances (`flash_errors`). With `tallies`, add the errors and
    `calls` calls of each kernel's time beside its plain version's and
    the library's (scaled_dot_product_attention with dropout_p = p, and
    its backward through autograd). Returns the worst error."""
    fargs = (q, k, v, bias, seed, H, p)
    out, lse = flash.flash_attention_fwd_generic(*fargs)
    grads = flash.flash_attention_bwd_generic(q, k, v, bias, seed, lse, g,
                                              H, p)
    out2, lse2 = flash.flash_attention_fwd_generic(*fargs)
    grads2 = flash.flash_attention_bwd_generic(q, k, v, bias, seed, lse, g,
                                               H, p)
    torch.cuda.synchronize()
    pout, plse = flash.flash_attention_fwd_plain(*fargs)
    pgrads = flash.flash_attention_bwd_plain(q, k, v, bias, seed, plse, g, H,
                                             p)
    got, want = (out, lse, *grads), (pout, plse, *pgrads)
    if q.dtype == torch.float32:
        cases = [within(a, b, *FP32_TOL) for a, b in zip(got, want)]
        errs, oks = [e for e, _ in cases], [ok for _, ok in cases]
        tol = "1e-5+1e-5|ref|"
    else:
        errs, oks = flash_errors(got, want)
        tol = "phase 3's"
    same = (torch.equal(out, out2) and torch.equal(lse, lse2)
            and all(torch.equal(a, b) for a, b in zip(grads, grads2)))
    print(f"  flash generic {what}: out {errs[0]:.3g}, lse {errs[1]:.3g},"
          f" dq {errs[2]:.3g}, dk {errs[3]:.3g}, dv {errs[4]:.3g} (tol"
          f" {tol}), repeated call bit-equal {same}", flush=True)
    check(all(oks), f"flash generic {what} disagrees with its plain twin")
    check(same, f"flash generic {what}: two calls on the same inputs differ")
    if tallies is None:
        return max(errs)
    fwd = tallies["flash_attention_fwd_generic"]
    bwd = tallies["flash_attention_bwd_generic"]
    fwd.errs += errs[:2]
    bwd.errs += errs[2:]
    lq, lk, lv = (t.detach().requires_grad_() for t in (q, k, v))
    lout = sdpa(torch, lq, lk, lv, bias, H, p)
    B, T, E = q.shape
    flops = 4.0 * B * T * k.shape[1] * E
    line = fwd.add(
        (q, k, v, bias, seed, out, lse), flops,
        time_ms(lambda: flash.flash_attention_fwd_generic(*fargs)),
        time_ms(lambda: flash.flash_attention_fwd_plain(*fargs)),
        time_ms(lambda: sdpa(torch, q, k, v, bias, H, p)), calls=calls)
    print(f"    time flash_attention_fwd_generic {what}: {line}")
    line = bwd.add(
        (q, k, v, bias, seed, lse, g, *grads), 2.5 * flops,
        time_ms(lambda: flash.flash_attention_bwd_generic(
            q, k, v, bias, seed, lse, g, H, p)),
        time_ms(lambda: flash.flash_attention_bwd_plain(
            q, k, v, bias, seed, plse, g, H, p)),
        time_ms(lambda: torch.autograd.grad(lout, (lq, lk, lv), g,
                                            retain_graph=True)), calls=calls)
    print(f"    time flash_attention_bwd_generic {what}: {line}")
    return max(errs)


def flash_generic_phase(torch, flash, tallies, worst) -> None:
    """Phase 27.1, flash. The generic kernels' dropout mask (v = I) equal
    to the plain generator's and to the fast kernel's at the shapes both
    take; at the fast kernels' shape (bf16, heads of 64, p = 0.1) the two
    routes' lse within 1e-5 and out within phase 3's tolerance; the fp32
    flagship's train-step calls (B=16, T=63, S' = 514 and 51, 16 heads of
    64, p = 0.1), timed, 4 layers each; head sizes 1, 4 (tiny_test), 8
    (the toy), 24, 129 and 256 in fp32 and bf16 at one and several query
    and key tiles, an item's keys padded, an item with every key padded;
    the shard forms at m = 2 (h0 = 0 and 8 of 16 heads) bit-equal to the
    whole launch's heads."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(27)
    f32, bf16 = torch.float32, torch.bfloat16
    name_f, name_b = "flash_attention_fwd_generic", "flash_attention_bwd_generic"

    def rn(dtype, *shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(dtype)

    seed = torch.tensor([5], dtype=torch.int32, device=dev)
    for B, T, S, H in ((2, 8, 64, 1), (2, 130, 128, 2)):
        eye = torch.eye(S, device=dev, dtype=bf16).repeat(B, 1, H)
        args = (rn(bf16, B, T, H * S, scale=0.3), rn(bf16, B, S, H * S), eye,
                torch.zeros(B, S, device=dev), seed, H, 0.25)
        kept = {route: (fn(*args)[0].float() > 0).view(B, T, H, S)
                .transpose(1, 2) for route, fn in (
                    ("generic", flash.flash_attention_fwd_generic),
                    ("fast", flash.flash_attention_fwd))}
        keep = flash.dropout_keep(seed, B, H, T, S, 0.25)
        same = bool(torch.equal(kept["generic"], keep)) and bool(
            torch.equal(kept["generic"], kept["fast"]))
        print(f"  flash generic dropout mask T={T} S'={S} H={H}: the plain"
              f" generator's and the fast kernel's {same}", flush=True)
        check(same, "the generic flash kernel drops other slots than the"
              " plain generator or the fast kernel")

    E, H, p = 1024, 16, 0.1
    seed = torch.tensor([1234], dtype=torch.int32, device=dev)

    def inputs(dtype, B, T, S, E, H, padded_item=False):
        q = rn(dtype, B, T, E, scale=(E // H) ** -0.5)
        k, v, g = rn(dtype, B, S, E), rn(dtype, B, S, E), rn(dtype, B, T, E,
                                                            scale=0.1)
        bias = torch.zeros(B, S, device=dev)
        bias[B // 2:, S // 2:max(S - 2, S // 2)] = -1e9
        if padded_item:
            bias[0] = -1e9
        return q, k, v, g, bias

    # The two routes at the fast kernels' shape, article context.
    q, k, v, g, bias = inputs(bf16, 16, 63, 514, E, H)
    (go, gl), (fo, fl) = (fn(q, k, v, bias, seed, H, p) for fn in (
        flash.flash_attention_fwd_generic, flash.flash_attention_fwd))
    e_l, ok_l = within(gl, fl, 1e-5, 1e-5)
    e_o, ok_o = within(go, fo, 0.02, 0.02)
    print(f"  flash generic against the fast kernel, bf16 B=16 T=63 S'=514"
          f" p={p}: lse {e_l:.3g} (tol 1e-5+1e-5|ref|), out {e_o:.3g} (tol"
          f" 0.02+0.02|ref|)", flush=True)
    check(ok_l and ok_o, "the generic and fast flash kernels disagree")

    # The fp32 flagship's train step, timed.
    for S in (514, 51):
        q, k, v, g, bias = inputs(f32, 16, 63, S, E, H)
        e = flash_generic_case(torch, flash, f"fp32 B=16 T=63 S'={S} p={p}",
                               q, k, v, g, bias, seed, H, p, tallies, calls=4)
        worst[name_f] = worst[name_b] = max(worst[name_f], e)

    # Head sizes, query and key tiles.
    for dtype in (f32, bf16):
        for E_, H_ in ((4, 4), (16, 4), (32, 4), (96, 4), (129, 1),
                       (256, 1)):
            for B, T, S in ((2, 10, 24), (3, 1, 5), (2, 70, 65), (2, 33, 1)):
                q, k, v, g, bias = inputs(dtype, B, T, S, E_, H_,
                                          padded_item=(B == 3))
                e = flash_generic_case(
                    torch, flash, f"{str(dtype)[6:]} B={B} T={T} S'={S}"
                    f" E={E_} H={H_} p={p}", q, k, v, g, bias, seed, H_, p)
                worst[name_f] = worst[name_b] = max(worst[name_f], e)

    # The held rows' edges: the last S' 64 rows hold at heads of 64 and
    # the first past it (32 rows), 16 rows, past 16 rows (the two walks);
    # heads of 256 at 16 rows and past them; T past one row tile.
    for dtype in (f32, bf16):
        for B, T, S, E_, H_ in ((2, 63, 552, E, H), (2, 63, 553, E, H),
                                (2, 70, 2000, E, H), (2, 20, 2325, E, H),
                                (2, 40, 514, 256, 1), (2, 9, 1213, 256, 1)):
            q, k, v, g, bias = inputs(dtype, B, T, S, E_, H_)
            e = flash_generic_case(
                torch, flash, f"{str(dtype)[6:]} B={B} T={T} S'={S} E={E_}"
                f" H={H_} p={p}", q, k, v, g, bias, seed, H_, p)
            worst[name_f] = worst[name_b] = max(worst[name_f], e)

    # Shard forms at m = 2: heads [h0, h0 + 8) of 16 against the whole
    # launch, bit for bit.
    for dtype, E_, H_ in ((f32, E, H), (bf16, 96, 4)):
        q, k, v, g, bias = inputs(dtype, 16, 63, 514, E_, H_)
        out, lse = flash.flash_attention_fwd_generic(q, k, v, bias, seed, H_,
                                                     p)
        grads = flash.flash_attention_bwd_generic(q, k, v, bias, seed, lse, g,
                                                  H_, p)
        m, w = 2, E_ // 2
        same = True
        for r in range(m):
            cols = slice(r * w, (r + 1) * w)
            sq, sk, sv, sg = (t[..., cols].contiguous() for t in (q, k, v, g))
            h0 = r * H_ // m
            sout, slse = flash.flash_attention_fwd_generic(
                sq, sk, sv, bias, seed, H_ // m, p, h0=h0, heads_total=H_)
            sgrads = flash.flash_attention_bwd_generic(
                sq, sk, sv, bias, seed, slse, sg, H_ // m, p, h0=h0,
                heads_total=H_)
            same = (same and torch.equal(sout, out[..., cols])
                    and torch.equal(slse, lse[:, h0:h0 + H_ // m])
                    and all(torch.equal(a, b[..., cols])
                            for a, b in zip(sgrads, grads)))
        print(f"  flash generic shard forms, {str(dtype)[6:]} E={E_} H={H_},"
              f" m = 2 (h0 = 0, {H_ // 2}): bit-equal to the whole launch's"
              f" heads {same}", flush=True)
        check(same, "a generic flash shard form differs from the whole"
              " launch")


def int8_generic_phase(torch, ops, greedy, beam, worst) -> None:
    """Phase 27.1, int8. `band_topk_lse_int8_generic` and
    `decode_cross_attention_int8_generic` against their plain versions,
    second calls bit-equal, the tables and K/V quantized from seeded ones
    by the port's own quantizers: the fp32 flagship's greedy step (16
    rows, k = 1, Q = 1) and beam-5 step (80 rows, k = 5, Q = 5) at B=16,
    timed (the three int8 word tables, the image and article contexts of
    every layer); tiny_test's widths in bf16 (embed 16, heads of 4, int8
    tables of 16 / 16 / 32 rows), the toy's in fp32 (embed 32, heads of
    8), other widths. Tolerances: fp32 1e-5 + 1e-5 |ref|; bf16 phase
    21's (values 0.03125, lse 1e-3 + 1e-4 |lse|, attention 0.02 + 0.02
    |ref|)."""
    from news_image_caption_tpu_torch.ops.adaptive import \
        quantize_embed_tables
    from news_image_caption_tpu_torch.ops.attention import (AttentionKV,
                                                            quantize_kv)
    band, xattn = ops
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(127)
    f32, bf16 = torch.float32, torch.bfloat16
    nb, na = "band_topk_lse_int8_generic", "decode_cross_attention_int8_generic"

    def rn(dtype, *shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(dtype)

    def tol(dtype, bf):
        return FP32_TOL if dtype == f32 else bf

    def bcase(dtype, N, D, V, k, tally=None):
        ((qt, _),) = quantize_embed_tables([(rn(dtype, V, D,
                                                scale=D ** -0.5), None)])
        x = rn(dtype, N, D)
        args = (x, qt.q, qt.scale, k)
        got = band.band_topk_lse_int8_generic(*args)
        again = band.band_topk_lse_int8_generic(*args)
        want = band.band_topk_lse_int8_plain(*args)
        torch.cuda.synchronize()
        logits = ((x.float() @ qt.q.float().T) * qt.scale.float()).to(
            dtype).float()
        tv = tol(dtype, (0.03125, 0.0))
        e_v, ok_v = within(got[0], want[0], *tv)
        e_l, ok_l = within(got[2], want[2], *tol(dtype, (1e-3, 1e-4)))
        e_i, ok_i = within(torch.gather(logits, 1, got[1].long()), want[0],
                           *tv)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        agree = (got[1] == want[1]).float().mean().item()
        what = f"{str(dtype)[6:]} N={N} D={D} V={V} k={k}"
        print(f"  {nb} {what}: values {e_v:.3g}, lse {e_l:.3g}, plain logit"
              f" at chosen ids {e_i:.3g}, ids equal {agree:.3f}, repeated"
              f" call bit-equal {same}", flush=True)
        check(ok_v and ok_l and ok_i and bool((got[1] >= 0).all())
              and bool((got[1] < V).all()), f"{nb} {what} disagrees with its"
              " plain version")
        check(same, f"{nb} {what}: two calls on the same inputs differ")
        worst[nb] = max(worst[nb], e_v, e_l)
        if tally is None:
            return
        tally.errs += [e_v, e_l]

        def library():
            lg = (x @ qt.q.to(dtype).T) * qt.scale
            return torch.logsumexp(lg, -1), torch.topk(lg, k)
        line = tally.add(
            (x, qt.q, qt.scale, *got), 2.0 * N * V * D,
            time_ms(lambda: band.band_topk_lse_int8_generic(*args)),
            time_ms(lambda: band.band_topk_lse_int8_plain(*args)),
            time_ms(library))
        print(f"    time: {line}", flush=True)

    def acase(dtype, B, Q, S, E, H, tally=None, one_key=False):
        bias = torch.zeros(B, S, device=dev)
        bias[B // 2:, S // 2:max(S - 2, S // 2)] = -1e9
        if one_key:
            bias[0] = -1e9
            bias[0, S // 3] = 0.0
        kv = quantize_kv(AttentionKV(rn(dtype, B, S, E), rn(dtype, B, S, E),
                                     bias), H)
        q = rn(dtype, B, Q, E, scale=(E // H) ** -0.5)
        args = (q, kv.k_q, kv.k_scale, kv.v_q, kv.v_scale, kv.bias, H)
        got = xattn.decode_cross_attention_int8_generic(*args)
        again = xattn.decode_cross_attention_int8_generic(*args)
        want = xattn.decode_cross_attention_int8_plain(*args)
        torch.cuda.synchronize()
        e, ok = within(got, want, *tol(dtype, (0.02, 0.02)))
        same = bool(torch.equal(got, again))
        what = (f"{str(dtype)[6:]} B={B} Q={Q} S'={S} E={E} H={H}"
                + (" (item 0: one key)" if one_key else ""))
        print(f"  {na} {what}: {e:.3g}, repeated call bit-equal {same}",
              flush=True)
        check(ok, f"{na} {what} disagrees with its plain version")
        check(same, f"{na} {what}: two calls on the same inputs differ")
        worst[na] = max(worst[na], e)
        if tally is None:
            return
        tally.errs.append(e)
        dh = E // H

        def widened(t, scale):
            return (t.to(dtype).view(B, S, H, dh) * scale[..., None]).view(
                B, S, E)

        def library():
            return sdpa(torch, q, widened(kv.k_q, kv.k_scale),
                        widened(kv.v_q, kv.v_scale), kv.bias, H)
        line = tally.add(
            (*args[:6], got), 4.0 * B * Q * S * E,
            time_ms(lambda: xattn.decode_cross_attention_int8_generic(*args)),
            time_ms(lambda: xattn.decode_cross_attention_int8_plain(*args)),
            time_ms(library), calls=4)
        print(f"    time, 4 layers: {line}", flush=True)

    # The fp32 flagship's steps at B=16, timed; 640 rows held.
    N, D, H = 16, 1024, 16
    for V in (5000, 15000, 30265):
        bcase(f32, N, D, V, 1, greedy[nb])
        bcase(f32, 5 * N, D, V, 5, beam[nb])
    bcase(f32, 640, D, 5000, 5)
    for S in (514, 51):
        acase(f32, N, 1, S, D, H, greedy[na])
        acase(f32, N, 5, S, D, H, beam[na])
    acase(f32, N, 5, 514, D, H, one_key=True)
    # The split plan's edges (one split, two, 11) and heads of 256.
    for dtype in (f32, bf16):
        for S in (64, 65, 128, 129, 700):
            acase(dtype, 3, 5, S, D, H)
        acase(dtype, 3, 16, 300, 256, 1)
    # tiny_test's widths in bf16, the toy's in fp32, other widths.
    for dtype, D_, Vs in ((bf16, 16, (16, 16, 32)), (f32, 32, (16, 16, 32))):
        for N_ in (1, 5):
            for V in Vs:
                for k in (1, 5):
                    bcase(dtype, N_, D_, V, k)
        for Q in (1, 4, 5):
            for S in (5, 6, 18):
                acase(dtype, 2, Q, S, D_, 4)
        acase(dtype, 3, 1, 6, D_, 4, one_key=True)
    for dtype in (f32, bf16):
        bcase(dtype, 37, 100, 129, 16)
        acase(dtype, 2, 3, 33, 39, 13)
        acase(dtype, 2, 16, 70, 512, 2)


def fp32_train_command_phase(torch, flash, counted):
    """Phase 27.2. The train command on the flagship YAML at
    trainer.mixed_precision fp32 (full width and depth, flash on, the
    YAML's dropouts, B=16), FP32_TRAIN_STEPS steps and a val batch: every
    flash call through the generic kernels (8 a train step or val batch
    forward, 8 a step backward), no fast flash launch; then the same
    command with `flash_cross_attention_plain` in the attention's place
    on the card (the same mask, drawn through `dropout_keep`): the first
    FP32_TRAIN_HELD steps' losses within 1e-5 relative. Returns
    ({path: {kernel: launches}}, summary)."""
    from news_image_caption_tpu_torch import cli
    from news_image_caption_tpu_torch.config import FLAGSHIP
    from news_image_caption_tpu_torch.ops import attention
    n_layers = FLAGSHIP["num_layers"]
    B, steps = 16, FP32_TRAIN_STEPS
    runs, launches, summary = {}, {}, {"card": card_line()}
    with tempfile.TemporaryDirectory() as tmp:
        for path in ("fp32_train_command", "fp32_train_plain_flash"):
            ovr = {"dataset": {"train": {"size": steps * B},
                               "val": {"size": B}, "test": {"size": B}},
                   "trainer": {"num_epochs": 1, "log_every": 1,
                               "num_serialized_models_to_keep": 1,
                               "optimizer": {"t_total": 100},
                               "mixed_precision": "fp32",
                               "serialization_dir": f"{tmp}/{path}"}}
            for fn in counted.values():
                fn.launches = 0
            real = attention.flash_cross_attention
            if path.endswith("plain_flash"):
                attention.flash_cross_attention = \
                    flash.flash_cross_attention_plain
            t = time.perf_counter()
            try:
                rc = cli.main(["train", EVAL_CONFIG, "-o", json.dumps(ovr)])
            finally:
                attention.flash_cross_attention = real
            wall = time.perf_counter() - t
            got = {n: fn.launches for n, fn in counted.items()}
            check(rc == 0, f"{path}: train returned {rc}")
            with open(f"{tmp}/{path}/metrics.jsonl") as f:
                recs = [json.loads(line) for line in f]
            train = [r["loss"] for r in recs if r["split"] == "train"]
            val = [r["loss"] for r in recs if r["split"] == "val"]
            check(len(train) == steps and len(val) == 1
                  and all(np.isfinite(train + val)), f"{path}: records {recs}")
            want = dict.fromkeys(counted, 0)
            if path == "fp32_train_command":
                want["flash_attention_fwd_generic"] = 2 * n_layers * (steps + 1)
                want["flash_attention_bwd_generic"] = 2 * n_layers * steps
            check(got == want, f"{path}: launches {got}, expected {want}")
            launches[path] = {n: c for n, c in got.items() if c}
            runs[path] = (train, val)
            summary[path] = {"wall_s": wall, "train_loss": train,
                             "val_loss": val, "launches": launches[path]}
            print(f"  {path}: {wall:.1f} s, losses"
                  f" {[round(x, 6) for x in train]}, val {val[0]:.6f},"
                  f" launches {launches[path]}", flush=True)
    (lk, vk), (lp, vp) = runs["fp32_train_command"], \
        runs["fp32_train_plain_flash"]
    rel = [abs(a - b) / abs(b) for a, b in zip(lk, lp)]
    summary["relative_loss_gaps"] = rel
    summary["val_relative_gap"] = abs(vk[0] - vp[0]) / abs(vp[0])
    print(f"  the generic kernels' losses against the plain flash path's:"
          f" relative gaps {[f'{r:.3g}' for r in rel]} (first"
          f" {FP32_TRAIN_HELD} held to 1e-5), val"
          f" {summary['val_relative_gap']:.3g}", flush=True)
    check(all(r <= 1e-5 for r in rel[:FP32_TRAIN_HELD]),
          "the fp32 train command's losses differ from the plain flash"
          " path's")
    return launches, summary


def tiny_generic_commands_phase(torch, counted):
    """Phase 27.3. `train configs/tiny_test.yaml` on the card in bf16 with
    use_flash_train at heads of 4 (the config's) and of 8 (2 heads):
    the flash calls through the generic kernels only, losses finite; then
    `evaluate configs/tiny_test.yaml` with generation.quantize_kv (random
    init, bf16 on the card, heads of 4): the context attention through
    the int8 generic variant only, finite metrics. Returns ({path:
    {kernel: launches}}, summary)."""
    import math

    from news_image_caption_tpu_torch import cli
    launches, summary = {}, {}
    keys = ("bleu-1", "bleu-4", "cider", "rouge-l")
    with tempfile.TemporaryDirectory() as tmp:
        for heads in (4, 2):
            path = f"tiny_bf16_flash_train_h{heads}"
            ovr = {"model": {"decoder": {"use_flash_train": True,
                                         "num_heads": heads}},
                   "trainer": {"mixed_precision": "bf16",
                               "serialization_dir": f"{tmp}/{path}"}}
            for fn in counted.values():
                fn.launches = 0
            t = time.perf_counter()
            rc = cli.main(["train", "configs/tiny_test.yaml", "-o",
                           json.dumps(ovr)])
            wall = time.perf_counter() - t
            got = {n: fn.launches for n, fn in counted.items()}
            check(rc == 0, f"{path}: train returned {rc}")
            with open(f"{tmp}/{path}/metrics.jsonl") as f:
                losses = [json.loads(line)["loss"] for line in f]
            check(losses and all(np.isfinite(losses)),
                  f"{path}: losses {losses}")
            check(got["flash_attention_fwd_generic"] > 0
                  and got["flash_attention_bwd_generic"] > 0
                  and got["flash_attention_fwd"] == 0
                  and got["flash_attention_bwd"] == 0,
                  f"{path}: launches {got}")
            launches[path] = {n: c for n, c in got.items() if c}
            summary[path] = {"s": wall, "losses": losses,
                             "launches": launches[path]}
            print(f"  train configs/tiny_test.yaml, bf16, flash, heads of"
                  f" {16 // heads}: {wall:.1f} s, losses"
                  f" {[round(x, 4) for x in losses]}, launches"
                  f" {launches[path]}", flush=True)
        path, ev = "tiny_test_evaluate_quantize_kv", f"{tmp}/evaluate"
        for fn in counted.values():
            fn.launches = 0
        t = time.perf_counter()
        rc = cli.main(["evaluate", "configs/tiny_test.yaml", "-o",
                       json.dumps({"generation": {"quantize_kv": True},
                                   "trainer": {"serialization_dir": ev}})])
        wall = time.perf_counter() - t
        got = {n: fn.launches for n, fn in counted.items()}
        check(rc == 0, f"{path}: evaluate returned {rc}")
        with open(f"{ev}/evaluate-metrics.json") as f:
            metrics = json.load(f)
        check(metrics["n_samples"] == 8
              and all(math.isfinite(metrics[k]) for k in keys),
              f"{path}: metrics {metrics}")
        check(got["decode_cross_attention_int8_generic"] > 0
              and got["decode_cross_attention_int8"] == 0
              and got["decode_cross_attention"] == 0
              and got["decode_cross_attention_generic"] == 0,
              f"{path}: launches {got}")
        launches[path] = {n: c for n, c in got.items() if c}
        summary[path] = {"s": wall, "metrics": {k: metrics[k] for k in keys},
                         "launches": launches[path]}
        print(f"  evaluate configs/tiny_test.yaml with quantize_kv:"
              f" {wall:.1f} s, metrics"
              f" { {k: round(metrics[k], 4) for k in keys} }, launches"
              f" {launches[path]}", flush=True)
    return launches, summary


def generic27_phase(torch, ops, counted):
    """Phase 27 (see the module): 27.1 the generic flash kernels and the
    int8 generic variants against their plain versions, 27.2 the fp32
    flagship's train command against the plain flash path, 27.3 the tiny
    config's bf16 flash training and its evaluate with quantize_kv, 27.4
    the fp32 flagship's greedy and beam-5 decodes under quantize_kv and
    quantize_head. Returns ({path: {kernel: launches}}, {kernel: result}
    of a train step (flash) or greedy step (int8), the beam-5 step's
    int8 results, the worst error a kernel, summary)."""
    band, xattn, flash = ops
    step = {n: Tally("fp32") for n in GENERIC27}
    beam = {n: Tally("fp32") for n in GENERIC27[2:]}
    worst = dict.fromkeys(GENERIC27, 0.0)
    t = time.perf_counter()
    flash_generic_phase(torch, flash, step, worst)
    int8_generic_phase(torch, (band, xattn), step, beam, worst)
    na = "decode_cross_attention_int8_generic"
    summary = {"kernels_s": time.perf_counter() - t, "redesigned": {
        "flash_attention_fwd_generic": print_redesigned(
            "flash_attention_fwd_generic", {
                "train step": step["flash_attention_fwd_generic"].result()}),
        na: print_redesigned(na, {"greedy": step[na].result(),
                                  "beam-5": beam[na].result()})}}
    counted = dict(counted, flash_attention_fwd=flash.flash_attention_fwd,
                   flash_attention_bwd=flash.flash_attention_bwd,
                   band_topk_lse_int8=band.band_topk_lse_int8,
                   decode_cross_attention_int8=(
                       xattn.decode_cross_attention_int8),
                   **generic_counted())
    launches, summary["fp32_train_command"] = fp32_train_command_phase(
        torch, flash, counted)
    more, summary["tiny_commands"] = tiny_generic_commands_phase(torch,
                                                                 counted)
    launches.update(more)
    more, summary["fp32_flagship_int8"] = generic_decode_phase(
        torch, counted, quantize=True)
    launches.update(more)
    summary["seconds"] = time.perf_counter() - t
    return (launches, {n: t_.result() for n, t_ in step.items()},
            {n: t_.result() for n, t_ in beam.items()}, worst, summary)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("CUDA is not available: this smoke run needs an NVIDIA GPU")
    from news_image_caption_tpu_torch.ops import (_build, band_topk,
                                                  decode_attention,
                                                  decode_blocks, dynamic_conv,
                                                  flash_attention)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print(card_line(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    _build.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)

    if len(sys.argv) > 1:
        usage = ("usage: chip_smoke.py [--serving-latency N_REQUESTS |"
                 " --mesh-overhead [ORDER]]")
        if sys.argv[1] == "--mesh-overhead" and len(sys.argv) <= 3:
            mesh_overhead_mode(torch, *sys.argv[2:])
            return
        check(len(sys.argv) == 3 and sys.argv[1] == "--serving-latency",
              usage)
        latency_mode(torch, int(sys.argv[2]))
        return

    print("phase 3: kernels vs plain versions (bf16, flagship shapes)",
          flush=True)
    timing, beam_timing = kernel_phase(
        torch, (band_topk, decode_attention, decode_blocks, _build))
    timing.update(flash_phase(torch, flash_attention))
    print(json.dumps({"beam5_step_b16": beam_timing}), flush=True)
    no_generic("3")

    print("phase 4: flagship serving (bf16, random weights)", flush=True)
    counted = {"band_topk_lse": band_topk.band_topk_lse,
               "decode_cross_attention": decode_attention.decode_cross_attention,
               "decode_conv_block": decode_blocks.decode_conv_block,
               "decode_ffn_block": decode_blocks.decode_ffn_block}
    launches, predict, jobs, outputs = serving_phase(torch, counted)
    by_path = {name: {"greedy": n} for name, n in launches.items()}

    print("phase 4b: flagship beam-5 search (bf16, random weights)",
          flush=True)
    beam_launches, beam_summary = beam_phase(torch, counted, predict)
    for name, n in beam_launches.items():
        launches[name] += n
        by_path[name]["beam5"] = n
    print(json.dumps({"beam5_requests": beam_summary}), flush=True)
    no_generic("4")

    print("phase 5: flagship train step (bf16_o2, random weights)",
          flush=True)
    train_launches, step_ms = train_phase(torch, flash_attention)
    launches.update(train_launches)
    by_path.update({name: {"train": n} for name, n in train_launches.items()})
    no_generic("5")

    print("phase 6: dynamic conv at full flagship width (bf16)", flush=True)
    conv_timing, launches["dynamic_conv"] = dynamic_conv_phase(torch,
                                                               dynamic_conv)
    by_path["dynamic_conv"] = {"conv_module": launches["dynamic_conv"]}
    timing.update(conv_timing)
    no_generic("6")

    print("phase 7: the evaluate command (flagship, bf16, random weights)",
          flush=True)
    eval_launches, eval_summary = evaluate_phase(torch, counted)
    for name, n in eval_launches.items():
        launches[name] += n
        by_path[name]["evaluate"] = n
    print(json.dumps({"evaluate": eval_summary}), flush=True)
    no_generic("7")

    print("phase 8: the train command, then evaluate from its checkpoints"
          " (flagship, bf16_o2)", flush=True)
    cmd_launches, ckpt_launches, cmd_summary, phase8 = train_command_phase(
        torch, flash_attention, counted)
    for name in cmd_launches:
        n = cmd_launches[name] + ckpt_launches[name]
        launches[name] += n
        by_path[name]["train_command"] = cmd_launches[name]
        by_path[name]["evaluate_checkpoint"] = ckpt_launches[name]
    print(json.dumps({"train_command": cmd_summary}), flush=True)
    no_generic("8")

    print("phase 9: the serve command (flagship, bf16, random weights),"
          " client, HTTP proxy and SIGTERM", flush=True)
    serve_launches, serve_summary = serve_phase(torch, predict, jobs,
                                                outputs)
    for name, n in serve_launches.items():
        launches[name] += n
        by_path[name]["serve"] = n
    print(json.dumps({"serve": serve_summary}), flush=True)
    no_generic("9")

    print("phase 10: the faces, objects, GloVe and no-image variants"
          " (bf16)", flush=True)
    variant_timing = variant_kernel_phase(torch, (decode_attention,
                                                  flash_attention))
    var_launches, var_summary = variant_command_phase(torch, flash_attention,
                                                      counted)
    var_summary["flagship_train_step_ms"] = {
        "phase5_step": step_ms, "phase8_command": cmd_summary[
            "step_ms_median"]}
    var_summary["evaluate_only"] = []
    for path, contexts in VARIANT_EVALUATE:
        more, summary = variant_evaluate_phase(torch, counted, path,
                                               contexts)
        var_summary["evaluate_only"].append(summary)
        for name, n in more.items():
            var_launches[name] += n
    for name, n in var_launches.items():
        launches[name] += n
        by_path[name]["variants"] = n
    print(json.dumps({"variants": {
        **var_summary, "launches": var_launches, "kernels": variant_timing,
        "card": card_line()}}), flush=True)
    no_generic("10")

    print("phase 11: speculative greedy, top-k sampling and the continuous"
          " slot pool (flagship, bf16, phase 4's weights)", flush=True)
    per_row = conv_positions_phase(torch, decode_blocks)
    pool_launches, pool_summary = pool_phase(torch, counted, predict)
    worker_launches, pool_summary["serve_continuous"] = \
        serve_continuous_phase(torch, predict,
                               serve_summary["b1_ms"]["client"])
    del predict
    pool_launches["serve_continuous"] = worker_launches
    for path, counts in pool_launches.items():
        for name, n in counts.items():
            launches[name] += n
            by_path[name][path] = n
    print(json.dumps({"continuous": {
        **pool_summary, "decode_conv_block_per_row": per_row,
        "launches": pool_launches, "card": card_line()}}), flush=True)
    no_generic("11")

    print("phase 12: the pointer family (copy_loss.yaml's train and"
          " evaluate, the gate forced open, the pool, only / faces pointer;"
          " bf16)", flush=True)
    ptr_launches, ptr_summary = pointer_phase(torch, flash_attention,
                                              counted)
    for path, counts in ptr_launches.items():
        for name, n in counts.items():
            if n:
                launches[name] += n
                by_path[name][path] = n
    print(json.dumps({"pointer": {**ptr_summary,
                                  "launches": ptr_launches}}), flush=True)
    no_generic("12")

    for family, title, phase in (
            ("lstm", "phase 13: the LSTM family (lstm_roberta.yaml's train"
             " and evaluate, a baseline_glove_lstm batch; bf16)", lstm_phase),
            ("gen2", "phase 14: the Gen-2 family (gen2_roberta.yaml's train"
             " and evaluate, a gen2_word batch, the pool; bf16)", gen2_phase)):
        print(title, flush=True)
        fam_launches, fam_summary = phase(torch, flash_attention, counted)
        for path, counts in fam_launches.items():
            for name, n in counts.items():
                if n:
                    launches[name] += n
                    by_path[name][path] = n
        print(json.dumps({family: {**fam_summary,
                                   "launches": fam_launches}}), flush=True)
        no_generic(title.split(":")[0][6:])

    print("phase 15: the online pipeline (transformer_weighted_roberta.yaml's"
          " train and evaluate from raw images, ResNet-152 and RoBERTa-large;"
          " bf16)", flush=True)
    pipe_launches, pipe_summary = pipeline_phase(torch, flash_attention,
                                                 counted)
    for counts in pipe_launches.values():
        for name, n in counts.items():
            if n:
                launches[name] += n
                by_path[name]["pipeline"] = \
                    by_path[name].get("pipeline", 0) + n
    print(json.dumps({"pipeline": {**pipe_summary,
                                   "launches": pipe_launches}}), flush=True)
    no_generic("15")

    for family, title, phase in (
            ("tgnc", "phase 16: TGNC (joganic_tgnc.yaml's train and evaluate,"
             " a greedy, speculative and pooled B=16 batch; bf16)",
             tgnc_phase),
            ("gen1", "phase 17: Gen-1 (gen1_show_attend_tell.yaml's train"
             " and evaluate, beam 5, attention maps, a greedy B=16 batch;"
             " bf16 decode)", gen1_phase)):
        print(title, flush=True)
        fam_launches, fam_summary = phase(torch, flash_attention, counted)
        for counts in fam_launches.values():
            for name, n in counts.items():
                if n:
                    launches[name] += n
                    by_path[name][family] = by_path[name].get(family, 0) + n
        print(json.dumps({family: {**fam_summary,
                                   "launches": fam_launches}}), flush=True)
        no_generic(title.split(":")[0][6:])

    print("phase 18: preprocess -> nics_shards -> train -> evaluate"
          " (ResNet-152 and RoBERTa-large on the card, bf16; the flagship"
          " YAML on the shards)", flush=True)
    # The shards stay for phase 22's loaders; removed at the end.
    shard_dir = tempfile.mkdtemp()
    data_launches, data_summary = data_phase(torch, flash_attention, counted,
                                             shard_dir)
    for path, counts in data_launches.items():
        for name, n in counts.items():
            if n:
                launches[name] += n
                by_path[name][path] = n
    print(json.dumps({"data_commands": {**data_summary,
                                        "launches": data_launches}}),
          flush=True)
    no_generic("18")

    print("phase 19: port a Transform-and-Tell best.th, then evaluate"
          " (flagship, bf16)", flush=True)
    port_launches, port_summary = port_phase(torch, counted)
    for name, n in port_launches.items():
        launches[name] += n
        by_path[name]["port_evaluate"] = n
    print(json.dumps({"port_command": {**port_summary,
                                       "launches": port_launches}}),
          flush=True)
    no_generic("19")

    print("phase 20: detection and captioning of a raw photo through"
          " full_model_builder (MTCNN, InceptionResnetV1, YOLOv3-SPP in"
          " fp32; transformer_faces.yaml in bf16)", flush=True)
    det_launches, det_summary = detect_caption_phase(torch, counted)
    for name, n in det_launches.items():
        launches[name] += n
        by_path[name]["detect_caption"] = n
    print(json.dumps({"detect_caption": det_summary}), flush=True)
    no_generic("20")

    print("phase 21: int8 context K/V and int8 head tables (kernels A and B"
          " at flagship shapes; greedy, beam-5, speculative, the pools,"
          " serve --quantize-kv --quantize-head, evaluate with quantize_kv;"
          " bf16)", flush=True)
    q_greedy, q_beam, q_chunk = quant_kernel_phase(
        torch, (band_topk, decode_attention))
    counted8 = dict(counted, band_topk_lse_int8=band_topk.band_topk_lse_int8,
                    decode_cross_attention_int8=(
                        decode_attention.decode_cross_attention_int8))
    q_launches, q_summary = quantize_phase(torch, counted8)
    for name in INT8_OF:
        launches[name] = 0
        by_path[name] = {}
    for path, counts in q_launches.items():
        for name, n in counts.items():
            if n:
                launches[name] += n
                by_path[name][path] = n
    timing.update(q_greedy)
    print(json.dumps({"quantize": {
        **q_summary, "beam5_step_b16": q_beam, "chunk4_b16": q_chunk,
        "launches": q_launches}}), flush=True)
    no_generic("21")

    print("phase 22: the profiler window of the train command, bf16 first"
          " moments, FixedStepsLoader over phase 18's shards and"
          " TokenBucketBatcher, the shift and lazy beam layouts (flagship,"
          " bf16)", flush=True)
    try:
        p22_launches, p22_summary = phase22(
            torch, flash_attention, counted, data_summary["shards"][:2])
    finally:
        shutil.rmtree(shard_dir, ignore_errors=True)
    for path, counts in p22_launches.items():
        for name, n in counts.items():
            if n:
                launches[name] += n
                by_path[name][path] = n
    print(json.dumps({"phase22": {**p22_summary,
                                  "launches": p22_launches}}), flush=True)
    no_generic("22")

    print("phase 23: the decoder's options at flagship width (lightweight"
          " conv, no GLU, pre-norm with final norm, conv_dim 512; remat,"
          " tied tail projections, tail dropout; the attention's and the"
          " adaptive softmax's module options; bf16)", flush=True)
    opt_launches, opt_summary = options_phase(
        torch, flash_attention, counted, (decode_attention, band_topk))
    for path, counts in opt_launches.items():
        for name, n in counts.items():
            if n:
                launches[name] += n
                by_path[name][path] = n
    print(json.dumps({"options": {**opt_summary,
                                  "launches": opt_launches}}), flush=True)
    no_generic("23")

    print("phase 24: parallelism at one rank (the train command with"
          " trainer.distributed, trainer.mesh and the sharded store on"
          " NCCL, evaluate from the sharded store, the ring and pipelined"
          " RoBERTa-large)", flush=True)
    mesh_launches, mesh_summary = mesh_phase(
        torch, flash_attention, counted, phase8, cmd_summary)
    for path, counts in mesh_launches.items():
        for name, n in counts.items():
            if n:
                launches[name] += n
                by_path[name][path] = n
    print(json.dumps({"mesh": {**mesh_summary,
                               "launches": mesh_launches}}), flush=True)
    no_generic("24")

    print("phase 25: tensor parallelism's shard forms at the flagship's"
          " layer widths (flash by heads, the FFN's partial mode, band"
          " top-k by rows, decode attention by heads; m = 2 and 4, every"
          " rank) and the split code at a model axis of one (bf16)",
          flush=True)
    tp_launches, tp_timing, shard_launches, tp_summary = \
        tensor_parallel_phase(torch, (band_topk, decode_attention,
                                      decode_blocks, flash_attention),
                              counted, mesh_summary)
    for path, counts in tp_launches.items():
        for name, n in counts.items():
            if n:
                launches[name] += n
                by_path[name][path] = n
    timing.update(tp_timing)
    # The shard forms run on no entry point of one card (SHARD_OF): their
    # launches are phase 25's calls of every rank of m = 2 and 4.
    for name in SHARD_OF:
        launches[name] = shard_launches[name]
        by_path[name] = {"shard_ranks_m2_m4": shard_launches[name]}
    print(json.dumps({"tensor_parallel": {**tp_summary,
                                          "launches": tp_launches}}),
          flush=True)
    no_generic("25")

    print("phase 26: the generic decode kernels (fp32, narrow widths, K ="
          " 1): each against its plain version on the card, the fp32"
          " flagship's greedy and beam-5 decodes, serve --task toy against"
          " --platform cpu over HTTP, train and evaluate of the tiny"
          " configs", flush=True)
    gen_launches, gen_greedy, gen_beam, gen_worst, gen_summary = \
        generic_phase(torch, (band_topk, decode_attention, decode_blocks),
                      counted)
    for name in GENERIC_OF:
        launches[name] = 0
        by_path[name] = {}
    for path, counts in gen_launches.items():
        for name, n in counts.items():
            if name in GENERIC_OF and n:
                launches[name] += n
                by_path[name][path] = n
    timing.update(gen_greedy)
    print(json.dumps({"generic": {
        **gen_summary, "beam5_step_b16_fp32": gen_beam,
        "max_abs_err_all_cases": gen_worst, "launches": gen_launches}}),
        flush=True)
    no_generic("26", GENERIC27)

    print("phase 27: the generic flash kernels and the int8 generic"
          " variants (fp32, any head size): each against its plain version"
          " on the card, the fp32 flagship's train command against the plain"
          " flash path, the tiny config's bf16 flash training and its"
          " evaluate with quantize_kv, the fp32 flagship's greedy and beam-5"
          " decodes under quantize_kv and quantize_head", flush=True)
    g27_launches, g27_step, g27_beam, g27_worst, g27_summary = \
        generic27_phase(torch, (band_topk, decode_attention,
                                flash_attention), counted)
    for path, counts in g27_launches.items():
        for name, n in counts.items():
            if name in GENERIC_OF and n:
                launches[name] += n
                by_path[name][path] = n
    timing.update(g27_step)
    gen_worst.update(g27_worst)
    print(json.dumps({"generic27": {
        **g27_summary, "beam5_step_b16_fp32": g27_beam,
        "max_abs_err_all_cases": g27_worst, "launches": g27_launches}}),
        flush=True)

    sources = {"band_topk_lse": ("band_topk.cu", "pallas_topk.py:124"),
               "decode_cross_attention": ("decode_attention.cu",
                                          "pallas_kernels.py:146"),
               "decode_conv_block": ("decode_blocks.cu",
                                     "pallas_decode.py:177"),
               "decode_ffn_block": ("decode_ffn.cu",
                                    "pallas_decode.py:133"),
               "flash_attention_fwd": ("flash_attention.cu",
                                       "pallas_flash.py:243"),
               "flash_attention_bwd": ("flash_attention.cu",
                                       "pallas_flash.py:266"),
               "dynamic_conv": ("dynamic_conv.cu", "pallas_kernels.py:72"),
               # The int8 variants: the kernels of the reference's int8
               # routes, which it computes in XLA beside these two.
               "band_topk_lse_int8": ("band_topk.cu", "pallas_topk.py:124"),
               "decode_cross_attention_int8": ("decode_attention.cu",
                                               "pallas_kernels.py:146"),
               # The shard forms of tensor parallelism (phase 25): the
               # same kernels over a model rank's heads, columns or rows.
               "flash_attention_fwd_shard": ("flash_attention.cu",
                                             "pallas_flash.py:243"),
               "flash_attention_bwd_shard": ("flash_attention.cu",
                                             "pallas_flash.py:266"),
               "decode_ffn_block_partial": ("decode_ffn.cu",
                                            "pallas_decode.py:133"),
               "band_topk_lse_shard": ("band_topk.cu", "pallas_topk.py:124"),
               "decode_cross_attention_shard": ("decode_attention.cu",
                                                "pallas_kernels.py:146"),
               # The generic variants (phase 26): the same four functions
               # at fp32, narrow widths and K = 1, where the reference's
               # TPU kernels are generic in dtype and width.
               "band_topk_lse_generic": ("decode_generic.cu",
                                         "pallas_topk.py:124"),
               "decode_cross_attention_generic": ("decode_generic.cu",
                                                  "pallas_kernels.py:146"),
               "decode_conv_block_generic": ("decode_generic.cu",
                                             "pallas_decode.py:177"),
               "decode_ffn_block_generic": ("decode_generic.cu",
                                            "pallas_decode.py:133"),
               # Phase 27's: the flash kernels at fp32 and any head size,
               # the int8 variants at fp32 and narrow widths.
               "flash_attention_fwd_generic": ("flash_generic.cu",
                                               "pallas_flash.py:243"),
               "flash_attention_bwd_generic": ("flash_generic.cu",
                                               "pallas_flash.py:266"),
               "band_topk_lse_int8_generic": ("decode_generic.cu",
                                              "pallas_topk.py:124"),
               "decode_cross_attention_int8_generic": ("decode_generic.cu",
                                                       "pallas_kernels.py:146")}
    kernels = [{"name": name, "route": "cuda",
                "source": f"news_image_caption_tpu_torch/csrc/{src}",
                "replaces": f"news_image_caption_tpu/ops/{tpu}",
                "launches": launches[name],
                "launches_by_path": by_path[name],
                "max_abs_err": timing[name]["max_abs_err"],
                "ms": timing[name]["ms"],
                "plain_ms": timing[name]["plain_ms"],
                "bound_ms": timing[name]["bound_ms"],
                "bound_by": timing[name]["bound_by"],
                "library_ms": timing[name]["library_ms"]}
               for name, (src, tpu) in sources.items()]
    for entry in kernels:
        if entry["name"] in INT8_OF:
            entry["variant_of"] = INT8_OF[entry["name"]]
        if entry["name"] in SHARD_OF:
            entry["shard_of"], entry["shard"] = SHARD_OF[entry["name"]]
        if entry["name"] in GENERIC_OF:
            entry["variant_of"] = GENERIC_OF[entry["name"]]
            entry["max_abs_err_all_cases"] = gen_worst[entry["name"]]
    # The conv block with a position a row (the pool's steps), at the
    # pool's 16 rows and the beam pool's 80, summed over the four layers.
    conv_entry = next(k for k in kernels if k["name"] == "decode_conv_block")
    conv_entry["per_row_positions"] = {f"N={n}": t for n, t in per_row.items()}
    print("(ms / plain_ms / library_ms / bound_ms: device time, CUDA events,"
          " and the card's least time at 3.35 TB/s and 989 TFLOP/s bf16 or"
          " 67 TFLOP/s fp32, of one decode step at"
          " batch 16 for the decode kernels and of one train step at batch"
          " 16 for the flash kernels, all layers; for dynamic_conv, one"
          " forward at B=16, T=512 of each flagship layer width, K ="
          " 3/7/15/31, summed, its library_ms the faster of the shift and"
          " band routes a width; for the int8 variants, a greedy step at"
          " B=16 under quantize_kv / quantize_head, library_ms the chain"
          " that widens the int8 operands and scales them before the"
          " product; for the shard forms, rank 0's at m = 2 over the same"
          " step's calls, launches phase 25's calls of every rank of m = 2"
          " and 4, max_abs_err every rank's against its plain version;"
          " for the generic variants, a greedy step of the fp32 flagship at"
          " B=16, library_ms the fast kernels' chains in fp32, the bound at"
          " fp32 bytes and 67 TFLOP/s, the generic flash kernels' a train"
          " step of the fp32 flagship at B=16, the int8 generic variants'"
          " a greedy step under quantize_kv / quantize_head;"
          f" train step {step_ms:.2f} ms)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
