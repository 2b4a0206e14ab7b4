#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (tpudf_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero; nothing falls
back to the CPU or to a twin):
  1. card name and power limit (nvidia-smi), build of every kernel from
     tpudf_torch/csrc with nvcc for sm_90a (one nvcc per source, in
     parallel), registers and spills from ptxas; K9's, K1's attention and
     K10's kernels (attention_sm90.cu, head_dim 64, 128 and 256, K1's also
     on the 80-wide tile, and the wide heads' kernels), kernels 11 and 12
     in bf16 (attention_plain_sm90.cu), the bf16 GEMM of K13, K14 and 15 in
     its three epilogue modes (bf16_gemm_sm90.cu), the int8 GEMM in its
     seven slot modes at both tile widths, its two f32-residual modes, its
     LN-panel instance, K5, and its quant-panel instances, the probes'
     quantising GEMMs (int8_gemm_sm90.cu), and 9b's main pass at heads of
     64 and 128 (attention_i8.cu), K6's cluster tile at tile widths 64,
     128 and 256 (attention.cu) and K7 (layer_int8.cu) must show wgmma
     (HGMMA; IGMMA for int8; both in K6 and K7) and TMA
     loads (UTMALDG) in their SASS where the toolkit's cuobjdump is
     present (its dump runs in the background during phase 2 and is read
     after it), no spills, and no wgmma serialised by ptxas (C7515); the
     wrappers'
     shared-memory functions equal to the kernels'; the host's cost of
     encoding a tensor map;
  2. each kernel against its plain PyTorch twin on the card (TF32 off for
     cuBLAS and cuDNN), tolerances below: K1-K4 at the detect core's
     shapes, K1 and K2 also at every token count of engine B's two ToMe
     schedules (checked, not timed), K9, K13 (LN + QKV, out-proj +
     residual, and the GELU epilogue) and K14 at the float engine's full
     analysis of 8 images (424 views, 108,544 rows); K10 (the backward of
     K9) at the MTL step's (16, 256, 2304) and at S=32, and the gradient
     through the attention autograd Function (K9 + K10) against the same
     Function through the twins; the W8A8 block's other routes: K5 (LN +
     quant + QKV, one launch) at (2048, 768 -> 2304) and at the detect
     core's ToMe row counts, K6 (attention + quant + out-proj + residual,
     one launch) at (8, 256, 2304) and its biased route (K9 + the out-proj
     GEMM) at a ToMe count, both within atol 5e-2 + rtol 2e-2 (the twin
     rounds the attention output to bf16 before its quant, the kernels
     quantise the f32 one); K7 (the whole layer, one cooperative launch)
     at (8, 256, 768) and (256, 32, 768), within the same and with at most
     K7_SHARE of its outputs not bit-equal to the twin's (the same math:
     only int8 ties differ), and the same checks shown to fail against the
     twin with a planted fault (the mid-layer residual rounded to bf16);
     K8 (LN + quant codes) at (2048, 768): codes equal to the twin's but
     for at most K8_SHARE of them, each within one code (f32 LN ties);
  2b. the same at the large backbones (`large_kernel_checks`): K4 and K8
     at so400m-512's width 1152, K5, K1 (with and without the key bias),
     K2 and K9 at large-384's (8, 576, 1024) and so400m-512's (8, 1024,
     1152) with heads of 72 padded to 128 and scale 72^-0.5, K6 at (8,
     576, 3 x 1024), K9 at engine A's (106, 576, 3072), K1 and K2 at every
     token count of large-384's two ToMe schedules; 9b (K9's dynamic-int8
     mode) at (8, 576, 3072) and (8, 1024, 6144); so400m's K1 runs its
     attention on the 80-wide tile (live = 72). The attention inputs are
     sharp (q, k and v of std 1.5, scores of std ~2.25), so that a wrong
     attention shows: K9 and 9b with at most ATTN_SHARE of the outputs
     more than a bf16 step from the twin, K1 and K6 with the error of
     their output within ATTN_REL of what the attention sublayer adds to
     its residual; each of these checks is shown to fail on a planted
     fault: the softmax scale taken from the padded head_dim (128^-0.5 in
     place of 72^-0.5; at large-384 the same 0.75 ratio), the key bias
     dropped, and for 9b aq taken over 64-row tiles instead of JAX's
     256-row query blocks; on inputs of std 0.5, the scale of JAX's own
     bound, 9b also within atol 1e-2 + rtol 2^-7 of its twin (at std 1.5
     one flipped probability code moves an output by up to ~3e-2) and
     within K9B_COS / K9B_REL of K9;
  2c. kernels 11 and 12 (`plain_attention_checks`: plain attention over
     separate q, k, v in the (B, H, S, D) and (B, S, H, D) layouts) at
     PLAIN_SHAPES (base-256's, large-384's and so400m's raw heads of 72
     at S = 1024, Sq != Skv with ragged keys, a single query, f32) on
     q, k, v of std 1.5: bf16 within atol 1e-2 + rtol 2^-7 with at most
     ATTN_SHARE of the outputs a bf16 step apart, f32 within atol 5e-4 +
     rtol 1e-3; each check shown to reject planted faults (the scale from
     the padded head_dim, the key mask dropped at Skv = 577 and 1000, the
     (B, H, S, D) head stride read by kernel 12, and at head_dim 72 its
     heads read 80 columns wide); the gradient through `attention`
     against the twins'; kernel, twin and SDPA timed;
  2d. K10 past S = 256 and at head_dim 128 (`k10_long_checks`): at
     K10_LONG (large-384's MTL and binary shapes at S = 576, S = 1024 with
     heads of 64, heads of 128 with so400m's scale 72^-0.5, the ragged S =
     1000) on q, k, v of std 1.5, within atol 1e-2 + rtol 2^-7 with at
     most ATTN_SHARE of the outputs a bf16 step apart, each check shown to
     fail on planted faults (the scale of the padded head_dim, the D term
     dropped, the ragged keys unmasked); kernel, twin and SDPA's backward
     timed; JAX's route at so400m's (16, 1024, 6144), d = 128: the twin's
     VJP, no K10 launch;
  2e. the probes' kernels 15, 16 and 17 (`probe_checks`, tpudf_torch/probes),
     each at its JAX probe's full shape against its twin on the same
     seeded inputs, with one launch a call (17: its pre-pass and its main
     pass; also at S = 1000 and on scores all negative, its pre-pass's
     codes bit-equal to the twin's) and the
     tolerances of tests/test_torch_port_probes.py (PROBE_TOL), each check
     shown to fail on planted faults (the quantising GEMMs' also: a panel
     slice left zero, the panel not rebuilt, a run of columns unstored,
     bias / GELU / scale dropped in half a tile; 17's also: the keys past S
     in the max or in l, a 64-key tile skipped, o without ap); 17's two
     launches timed alone beside 9b's main pass on the same codes
     (`k17_timings`); k_pure also bit-equal to
     torch._int_mm; the quantising GEMMs' split form bit-equal to their
     one launch, their own route at K = 1600 (split) against the twin,
     each form and its parts timed by device time; then each probe's
     main() (its timing lines), whose launches are the kernels line's
     count;
  2f. K1, K6, K9 and 9b past S = 1024 (`long_seq_checks`): at S = 1296
     and a ragged S (1304 for K1 and K6, 1297 for K9 and 9b), at
     base-256's width with heads of 64 and of 128 (72 live: K1 on the
     80-wide tile), on q, k, v
     of std 1.5 with and without the key bias, one launch each, to phase
     2b's tolerances, each check shown to fail on planted faults (the
     scale, the bias dropped, 9b's aq over 64-row tiles, the keys past S
     unmasked);
  2g. the bf16 GEMM launch (`gemm_checks`) at GEMM_SHAPES (a ragged M with
     K % 64 == 32 and a half tile, a half tile after two whole ones, the
     out-projection's square, the engine's QKV product) in MODE 0 with and
     without a bias, MODE 1 and MODE 2 against its twin: atol 1e-2 + rtol
     2^-7 and at most GEMM_SHARE of the outputs a bf16 step apart, each
     check shown to fail on planted faults (a K step skipped, the bias,
     GELU or the residual dropped, the weight read K-major); then the
     launch alone at K13's and K14's products of engine A's full analysis
     beside F.linear (`gemm_path_timings`: device times, the factor
     against GEMM_TARGET, the tensor maps a launch encodes);
  2h. heads of 16, 32, 256 and 384-1280 (`headdim_checks`, ROADMAP Queue
     C 1 and 2): K9 and 9b at S = 576 and 577, K10, K1 and K6 (through a
     W8A8 layer; at the wide heads K6 as two launches) at 576 and 584, in
     48 heads of 16, 24 of 32 and 3 of 256 (W = 768), 2 of 384 (768), 2
     of 640 and 1 of 1280 (1280), q, k, v of std 1.5, with and without
     the key bias, one launch each, by the card rules of phases 2b / 2d
     (K10: the share rule, and its largest error from float64 within
     K10_F64_FACTOR of the twin's); each check shown to fail on planted
     faults (the scale of a 64-wide head, a padded column left non-zero,
     the second column slice of a wide head dropped, a 128-deep chunk of
     the scores skipped, one 64-row block of one head at a wrong scale,
     the bias dropped, the keys past a ragged S unmasked);
  2i. the int8 GEMM launch (`i8_gemm_checks`, int8_gemm_sm90.cu) at
     I8_SHAPES in each mode: kEpiI32 bit-equal to torch._int_mm, the
     others against the twin's epilogue on the kernel's own int32 sums
     (at most I8_SHARE of the outputs not bit-equal, none more than a
     bf16 step or one code apart), the sum of out^2 within rtol 1e-4;
     each check shown to fail on planted faults (a 128-deep K slice skipped, a
     weight box dropped, the bias, GELU or residual dropped, act_out
     ignored, the weight read with the wrong swizzle); then the launch
     alone at I8_PATHS beside torch._int_mm (`i8_gemm_path_timings`) and
     K4 alone at LN_SHAPES beside F.layer_norm (`ln_timings`), device
     times into the kernels line;
  2j. K1's attention launch alone (`k1_attention_checks`) at the first
     layer of each detect core phase 4 times and at B = 8: its int8 codes
     against the twin's (at most K1_CODE_SHARE differ, by one), with and
     without the bias, shown to fail on planted faults (the scale, the
     bias dropped, and on so400m's 80-wide tile the codes of columns
     80-127 left as a pre-filled buffer had them and columns 72-79 that
     hold values read as zeros); its device time beside its bound, SDPA
     and K9, into K1's row of the kernels line;
  2k. K5 and 9b on wgmma + TMA (`k5_9b_checks`): K5 at K5_SHAPES (65536
     rows, where blocks walk several row tiles; 8 x 257 rows; W = 832 and
     1280) within atol 5e-2 + rtol 2e-2 of its twin, bit-equal to K8 + the
     int8 GEMM and to itself over repeated launches, each shape's check
     shown to fail on planted faults (no panel rebuilt after a block's
     first unit, a 128-deep panel slice zero, g dropped, the act scale
     ignored, one run of columns left as a pre-filled output had them);
     9b's wgmma pass at K9B_SHAPES (heads of 64 and 128, S = 576, 1024 and
     a ragged 1297): the pre-pass's codes bit-equal to their plain
     version, the output by phase 2b's share rule, shown to fail on faults
     planted in the pre-pass's scratch (v8t in natural key order, k8 from
     each 64-key tile's amax, non-zero codes past a ragged S); then K5's
     launch alone at K5_TIMED beside its bound, K8 + the int8 GEMM and the
     PyTorch parts, and 9b's pre-pass and main pass at K9B_TIMED beside
     their bound, K9 and SDPA, device times into the kernels line;
  2l. K6 and K7 on wgmma + TMA (`k6_k7_checks`): K6's cluster tile at
     K6_SHAPES (the B = 8 detect cores' (8, 256, 2304) and (8, 576, 3072),
     (256, 32, 2304), heads of 16 / 32 / 128 / 256 at S 576 / 584), one
     launch each, its cluster size and shared memory equal to the
     wrapper's, by phase 2b's rule against its twin, bit-equal to K1's
     attention launch + the int8 GEMM (GEMM_RESIDUAL) and over repeated
     launches, each shape's check shown to fail on planted faults (one
     CTA's heads never received into the panels, the panel unswizzled, a
     128-column weight tile skipped, bias or residual dropped, the scale
     x0.75, the keys past a ragged S unmasked); K7 at (8, 256, 768) and
     (256, 32, 768) by its card rule, bit-equal over repeated launches,
     shown to fail with x1 rounded to bf16, LN2 over x, GELU dropped and a
     phase-3 row tile started early; each launch alone by device time: K6
     beside its split form, bound and SDPA + `_int_mm`, K7 beside the FPP
     layer and its bound;
  2m. ROADMAP Queue C 1-3 and K3 (`queue_c_checks`, `k3_checks`): K6
     past its panel on its split route (QC_K6), K7 where JAX's decision
     runs it (QC_K7: one launch on the 64- and 128-wide tiles, or its split
     form), the row pass at QC_LN (K4, K8 and the f32 pass), K5 past its
     panel (K8 + the int8 GEMM, bit-equal), K1 and K2 at W 1408, each with
     planted faults that must fail by at least twice the tolerance; K8
     re-timed alone; the queue's blocks (base-256's at S = 64 under LLL,
     one at W 1408 under LLL and PPP: the split forms' launches); K3 on its
     strips at K3_BATCHES (bit-identical over launches, planted faults:
     halo rows zeroed, a strip's partial missing, a clamped border), each
     timed beside its bound and the library's parts;
  3. the paths, each driven with the launch counts set to 0 just before it
     and read just after:
     (a) the detect core (build("cuda", seed=0), base-256, W8A8 + ToMe),
         requests of 8 and 256 seeded bf16 images: finite outputs, p_blend
         in [0, 1], risk_probs rows summing to 1, launches per forward
         (K1 12, K2 12 of which 4 emit Σout², K3 1, K4 2), and the same
         parameters through the twins: pooled cosine >= 0.99,
         |Δp_blend| <= 1e-2;
     and the same forwards under TPUDF_INT8_KERNELS=PPP, XXX and LLL
     (K5/K6, K8 and the int8 products; under LLL FPP, since JAX's K7
     fits no layer of base-256: 14.0 MB at S = 256, a ToMe bias after):
     exact launches per forward and route, the same checks against the
     twins; and the tower without ToMe at B=8 under LLL and PPP, so that
     all 12 layers run FPP, or K5 and K6, against the twins (pooled cosine
     >= 0.99);
     (b) engine A, build_engine("cuda") (bf16 tower, no ToMe, linear
         fusion): a full analysis of 8 uint8 images and a fast request of
         32; (c) engine B, build_engine("cuda", int8=True, tome=True,
         patch_tome=True): a full analysis of 8. For each request: every
         output finite and of its shape, p_blend / patch_probs / max_patch
         in [0, 1], max_patch >= patch_mean, risk_probs rows summing to 1,
         exact launches per request (`engine_expect`), and the same engine
         through the twins: pooled cosine >= 0.99 on every view of every
         tower forward (`pooled_features`: main and patch views, or the
         fast pair), |Δ| <= 1e-2 on p_blend, visual_prob, freq_prob and
         (full) patch_probs, max_patch, patch_mean, |Δ| <= 5e-2 on the
         logits z_sig and z_freq (engine B: visual_prob and z_sig at twice
         these, for int8 rounding ties);
     (d) the MTL trainer, build_mtl_trainer(mtl_params("cuda"))
         (base-256, decoder embed_dim 256 on taps (2, 6, 10, -1),
         freeze_below=9, batch 16, bf16 compute on f32 masters, lr 5e-5
         after a warmup of 1 step, so that 4 of the 5 updates move the
         weights): (a) the float prefix and (b) the int8 prefix
         (--int8_frozen, calibrated on the first batch's 16 images), 5
         steps each on the same seeded batches through the kernels and
         through the twins: finite losses, exact launches per step,
         |Δloss| per step, the step-1 gradient cosine
         per group (top blocks, heads, decoder) >= 0.99, and per slice of
         the trainable parameters (a block layer's leaf, a third of a
         fused q|k|v leaf) the step-1 gradient's relative error and the
         mean |Δp| after 5 steps in units of lr, frozen parameters
         bit-identical after 5 steps, eval outputs finite with seg
         probabilities in [0, 1]; then (a) with K10's dQ, dK or dV zeroed
         must fail those slice checks; every trainer of this script starts
         from a copy of one initial tree a config (`fresh`);
     (s) (`sid_paths`): the MTL CLI's default route without --data_dir
         at base-256, 256 px, B = 16, freeze_below 9, one epoch, float as
         `python -m tpudf_torch.cli.train_mtl` in a process of its own and
         --int8_frozen by its main in this one, on 48 + 32 seeded SID_Set
         records of every schema variant served by a stand-in `datasets`
         (on PYTHONPATH for the process, in sys.modules here): the
         stand-in's name and splits, each record read once, each record's
         class, has_mask and mask sum as mapped, (d)'s launches a step, finite losses, the log and checkpoint, frozen
         leaves bit-identical and every trainable slice moved; a stand-in
         that raises ends the CLI with "provide --data_dir";
     (e, f) the detect core of large-384 and of so400m-512
         (build(cfg_name=...), every layer at full width) at B=8 under
         FPP, PPP, XXX and LLL with ToMe, and the tower without ToMe under
         each, so400m-512's PPP also with TPUDF_INT8_ATTN=1 (9b): exact
         launches (`w8a8_launches`), pooled cosine >= 0.99 against the
         twins, |Δp_blend| <= 1e-2; (g) large-384's engines A and B
         (build_engine(cfg_name="large-384")): a full analysis of 8 and a
         fast request of 32 with exact launches, held against the twins
         on 2 images (`engine_request`);
     (w1)-(w5) (`weights_paths`): an HF state dict of large-384 built by
         name, converted by `python -m tpudf_torch.models.convert` and held
         leaf for leaf against its sources, served by build_engine(...,
         backbone_ckpt=) A and B (a full analysis of 8); the MTL trainer
         fine-tuning large-384 at 256 px from it (interpolated position
         table), float and int8 prefix, 3 steps against the twins, and the
         MTL CLI's main for one step; the
         multi-query `_mha` at full width through kernels 11 and 12;
         so400m-512's engines A and B (its MLP padded to 4352); so400m's
         dynamic-int8 tower and an un-prepadded static tree;
     (r) the image report (`report_paths`,
         tpudf_torch.serve.report.predict_images) on base-256's and
         large-384's engines A and B, full at B = 8 and fast at B = 32, on
         seeded images (the golden corpus' recipe and noise), with cuDNN's
         TF32 at PyTorch's default: exact launches (a report launches
         what the engine's request does; the fusion tail none),
         `dispatch_images` under torch's sync check set to raise (no
         sync in the core, the tail or the face step), the
         reports against the same engine's through the twins (strings,
         ints and bools equal but for a step at a threshold, the core's
         floats by (b)'s limits, the battery's by the goldens' atol 2e-4
         + rtol 2e-3), the battery's cues against the port's battery on
         the CPU for the same pixels; large-384's engine B once with the
         three artifacts attached and once with a face box that escalates
         (the engine's launches twice); planted faults that must fail
         these checks: the tail fed the un-resized pixels, the full tail
         reading the fast path's core columns (TF32 left on: reported);
     (v) the video report (`video_paths`,
         tpudf_torch.serve.report.predict_video) on the same engines, 12
         frames at the engine's size (the golden recipe rolled 2 px a
         frame; at base-256 also a scene cut): exact launches (the fast
         batch, the battery's tower forward without ToMe, the chosen
         frame's full request), id_drift and the face trio present where
         the clip allows, the report against the twins' (the battery's
         signals bit-equal, the tower's floats by (b)'s limits, labels and
         the chosen frame equal but for a step: `video_tie`, the frames'
         fast reports), embed_batch against the twins (unit rows), the
         battery against the port's on the CPU (goldens' rule, a
         thresholded cue shown to be a step: `video_steps`) and bit-equal
         to itself with TF32 off, the face nets' outputs, the landmarks
         in px and the face trio against the port's on the CPU (a crop
         corner a pixel apart shown to be a step: `face_vs_cpu`),
         base-256 B with TPUDF_FACE_ID_EMBED=0 (the face trio through
         embed_batch), the battery under torch's sync check set to raise;
         planted faults that must fail: the backward flow's sign flipped,
         large-384's frames fed to the battery un-resized, the embeddings
         un-normalised, TF32 on in the battery and the face nets, TF32 on
         in the face nets alone; the sampler (data/video.sample_video) on an mp4v file
         cv2 writes, its route printed, its frames through predict_video;
     (i) (`cli_paths`): the inference CLI, tpudf_torch.cli.infer.main at
         base-256 with --int8 --tome_r --patch_tome --device cuda, on a
         seeded folder of 48 JPEG and PNG images (and the same list as a
         CSV): --fast --labels_from_dirs --calibrate --few_shot linear,
         full on 8 images, --few_shot kernel on the CSV, --video on an
         mp4v clip; each request's launches phase 3r's (the counts set to
         0 just before it), its pixels `_decode_image`'s, its JSONL
         reports against a fresh request and the twins' by phase 3r's
         rules, the probes trained on the card against the CPU's; the
         JPEGs' decode route and the CLI's img/s and ms a clip printed;
         planted faults that must fail: the decode forced to PIL where
         the native decoder loads, the full tail reading the fast core;
     (u) (`app_paths`): the app's predict_image and predict_clip over
         that engine against fresh requests (launches phase 3r's), the
         forensic maps, overlay, panel and collage on the card against
         the port's CPU run (TF32 left on in the maps: a planted fault,
         reported), the forensics CLI's scores.json against
         forensic_battery;
     (t2)-(t4) (`training_rest`, LARGE_STEPS steps a run): large-384 MTL
         at 384 px (K10 at S = 576) float and int8 prefix; so400m-512 MTL
         (K14 at the padded hidden of 4352, K10's route the twin's VJP);
         the binary trainer (`build_binary_trainer`) at large-384: the
         frozen bf16 tower (v5 head with EMA and mixup; the fast head) and
         the W8A8 + ToMe tower at B = 64, the tower trained at B = 8 with
         and without remat (2 steps), each against the twins with exact
         launches; the binary CLI for an epoch, then --evaluate_only
         --resume;
     (x) (`trainer_paths`): the experts CLI, the video CLI (bf16 and
         W8A8, with --analysis: its launches exact, learning_analysis.json
         with JAX's keys, the figures where matplotlib is installed, the
         activation statistics against the twins' features), the face
         nets against their CPU runs;
     (p) (`parallel_paths`): p1, a world of 1 on NCCL in this process:
         sharded_detect_core on engine B bit-equal to predict_batch with
         its launches, 3 ShardedTrainer steps (base-256 tower trained, B =
         8) against the single-process replay; p2, 2 gloo ranks on this
         card under torchrun: the tower split by heads (6 a rank) against
         the single-process forward, 12 K9 and 48 K13 a rank and no K14;
         p3, 4 gloo ranks, mesh (2, 2): 3 split trainer steps against the
         replay (K10 a block a rank), engine B's request of 13 over the
         data axis against the single-process request; each limit
         between its sound reading and a planted fault of the CPU
         rehearsal;
  4. K9 and K10 at the paths' shapes beside SDPA's forward and backward,
     kernels 11 and 12 at every PLAIN_SHAPES case beside SDPA
     (`attention_factors`: each factor, from phases 2, 2b, 2c and 2d of
     this run); CUDA-event timings: each kernel vs its twin and, where one
     PyTorch call computes the same function or a part of it, that call
     (timed here only; the port never calls it; the SDPA backward by its
     kernels' device time from torch.profiler); the detect-core forwards
     and the engine requests, kernels vs twins, and the core under each
     opt-in TPUDF_INT8_KERNELS route at B = 256 (kernels); the train steps
     of (a) and (b), kernels vs twins; torch.profiler traces (the device's
     activity) of the detect core at B=256, of engine A's full analysis
     and of a train step of (a): the largest kernels and the device's
     idle share; the trainer's peak
     memory; the large backbones' detect cores (large-384 at B=8 and 128,
     so400m-512 at B=8 and 64) with a profile each, so400m-512's PPP
     tower with and without TPUDF_INT8_ATTN=1, the towers without ToMe at
     B = 8 by events and device time (large-384 under PPP: 24 K6 launches;
     base-256 under PPP and LLL: 12 K6 / K7), large-384's engines; the
     large-384 MTL step at 256 px, (a) and (b), with a profile of (a),
     and so400m-512's engines A and B; the (t) steps, each with a profile
     but t2 (b), the fast head and the remat step
     (`training_rest_timings`); each report request of (r) by the host
     clock, split into the engine's core and the fusion tail (CUDA
     events) and the rest, with a profile (idle share) of two of them
     (`report_timings`); each video request of (v) by the host clock,
     split into the fast batch, the battery, the face trio and the chosen
     frame's full request (CUDA events), with a profile of one of them
     (`video_timings`); the video CLI's --analysis by the host clock; the
     world-1 DP full analysis against the engine's own request
     (`parallel_timings`).
Prints a wall clock line at the end of each phase ("clock: ...") and one
for parts of the longer phases ("lap: ..."), a
JSON line of the kernels (with each one's bound: the larger of
its operations over the card's peak for their type and its bytes, each
input read once and each output written once, over 3.35 TB/s), the card
line, and last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import atexit
import collections
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

REPLACES = {
    "K1": "tpudf/ops/int8_block.py:121",
    "K2": "tpudf/ops/mlp.py:116",
    "K3": "tpudf/ops/srm.py:97",
    "K4": "tpudf/ops/layernorm.py:18",
    "K5": "tpudf/ops/int8_block.py:44",
    "K6": "tpudf/ops/int8_block.py:390",
    "K7": "tpudf/ops/int8_block.py:272",
    "K8": "tpudf/ops/layernorm.py:72",
    "K5-split": "tpudf/ops/int8_block.py:44",
    "K6-split": "tpudf/ops/int8_block.py:390",
    "K7-split": "tpudf/ops/int8_block.py:272",
    "K9": "tpudf/ops/attention.py:167",
    "K10": "tpudf/ops/attention.py:308",
    "K13": "tpudf/ops/linear.py:20",
    "K14": "tpudf/ops/mlp.py:21",
    "K9b": "tpudf/ops/attention.py:209",
    "K11": "tpudf/ops/attention.py:53",
    "K12": "tpudf/ops/attention.py:108",
    "15-bf16": "scripts/micro_pallas_int8.py:21",
    "15-int8": "scripts/micro_pallas_int8.py:27",
    "16-full": "scripts/micro_epilogue.py:28",
    "16-nogelu": "scripts/micro_epilogue.py:39",
    "16-bf16_epi": "scripts/micro_epilogue.py:48",
    "16-noquant": "scripts/micro_epilogue.py:59",
    "16-pure": "scripts/micro_epilogue.py:67",
    "17": "scripts/micro_attn_static.py:79",
}
SOURCES = {
    "K1": "tpudf_torch/csrc/attention_sm90.cu",
    "K2": "tpudf_torch/csrc/int8_gemm_sm90.cu",
    "K3": "tpudf_torch/csrc/srm.cu",
    "K4": "tpudf_torch/csrc/layernorm.cu",
    "K5": "tpudf_torch/csrc/int8_gemm_sm90.cu",
    "K6": "tpudf_torch/csrc/attention.cu",
    "K7": "tpudf_torch/csrc/layer_int8.cu",
    "K8": "tpudf_torch/csrc/layernorm.cu",
    # the split forms: launches of those files composed in
    # tpudf_torch/ops/int8_block.py (K5: layernorm.cu + int8_gemm_sm90.cu;
    # K6: attention_sm90.cu + int8_gemm_sm90.cu; K7: those, the f32 row pass
    # and the GEMM's f32 residual epilogues)
    "K5-split": "tpudf_torch/ops/int8_block.py",
    "K6-split": "tpudf_torch/ops/int8_block.py",
    "K7-split": "tpudf_torch/ops/int8_block.py",
    "K9": "tpudf_torch/csrc/attention_sm90.cu",
    "K10": "tpudf_torch/csrc/attention_sm90.cu",
    "K13": "tpudf_torch/csrc/bf16_gemm_sm90.cu",
    "K14": "tpudf_torch/csrc/bf16_gemm_sm90.cu",
    "K9b": "tpudf_torch/csrc/attention_i8.cu",
    # bf16 (the paths' dtype); f32 runs tpudf_torch/csrc/attention_plain.cu
    "K11": "tpudf_torch/csrc/attention_plain_sm90.cu",
    "K12": "tpudf_torch/csrc/attention_plain_sm90.cu",
    "15-bf16": "tpudf_torch/csrc/bf16_gemm_sm90.cu",
    "15-int8": "tpudf_torch/csrc/int8_gemm_sm90.cu",
    "16-full": "tpudf_torch/csrc/int8_gemm_sm90.cu",
    "16-nogelu": "tpudf_torch/csrc/int8_gemm_sm90.cu",
    "16-bf16_epi": "tpudf_torch/csrc/int8_gemm_sm90.cu",
    "16-noquant": "tpudf_torch/csrc/int8_gemm_sm90.cu",
    "16-pure": "tpudf_torch/csrc/int8_gemm_sm90.cu",
    "17": "tpudf_torch/csrc/attention_i8.cu",
}
# dense peaks of one H100 SXM (NVIDIA's data sheet) and its memory rate
PEAK = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 2 ** 20             # the H100's L2
# f32 operations per element of the two elementwise kernels (K3: the two
# separable 3-tap stencils and the four moments of two residuals; K4: the
# sums, the normalisation and the affine)
K3_OPS_PER_PIXEL = 30
K4_OPS_PER_ELEMENT = 8
K8_OPS_PER_ELEMENT = 11          # K4's and the quant's mul, round, clamp
# K7's outputs not bit-equal to its twin's (int8 ties only: 2.7e-3 at
# (8, 256, 768), 1.5e-2 at (256, 32, 768) on an H100; the twin with the
# mid-layer residual rounded to bf16 differs in 0.75 of them), and K8's
# codes that differ from the twin's (f32 LN ties)
K7_SHARE = 5e-2
K8_SHARE = 1e-4
# K9 and 9b (K9's dynamic-int8 mode) against their twins at the large
# backbones: at most ATTN_SHARE of the outputs more than one bf16 step
# apart (9b: a probability code p*127/ap at a rounding tie may flip, as exp
# and the row sum round apart; 9.5e-5 and 5.6e-5 on an H100 at std 0.5,
# against 0.29 and 0.19 for the twin with aq over 64-row tiles; K9 and 9b
# at std 1.5 at most 1.2e-4, their planted faults at least 0.34). K1 and
# K6: |out - twin| / |twin - x| at most ATTN_REL (the twin quantises the
# bf16-rounded attention output, the kernels the f32 one, so some of o's
# int8 codes differ by one: 9.6e-3 to 1.4e-2 on an H100, the planted
# faults at least 0.34). 9b against K9's bf16 output: cosine >= 0.99
# per row and max|Δ| / max|K9| <= 2e-2, the bound tests/test_attention.py
# puts on the JAX mode (at its inputs' scale, std 0.5)
ATTN_SHARE = 1e-2
ATTN_REL = 5e-2
K9B_COS, K9B_REL = 0.99, 2e-2
# the large backbones (SigLIPConfig): width, heads, head_dim as the kernels
# see it (so400m's 72 padded to 128), the softmax scale, MLP width as the
# kernels see it (4304 padded to 4352), tokens
LARGE = {"large-384": (1024, 16, 64, None, 4096, 576),
         "so400m-512": (1152, 16, 128, 72 ** -0.5, 4352, 1024)}
# the TPUDF_INT8_KERNELS routes the detect core is driven under
ROUTES = ("PPP", "XXX", "LLL")
# the engines' full analysis: 53 views per image
VIEWS = 53
# the MTL trainer of the smoke run: batch, steps, freeze boundary, and the
# kernel-vs-twin limits of its losses (int8 ties move (b)'s further: up to
# 3.1e-3 over the 5 steps on an H100, against 1.4e-3 for (a))
MTL_BATCH, MTL_STEPS, MTL_FREEZE, MTL_LR = 16, 5, 9, 5e-5
# steps of the large backbones' trainers against their twins (phases 3w,
# 3t): base-256's 5 (phase 3 (d)) hold the per-slice limits and their
# planted faults; the large ones repeat those checks at their widths
LARGE_STEPS = 3
MTL_DLOSS = {"a": 1e-2, "b": 2e-2}
# per slice of the trainable parameters (a block layer's leaf, or a third
# of a fused q|k|v leaf): the step-1 gradient's relative error, and the
# mean |Δp| after the 5 steps in units of lr (warmup of 1 step: 4 updates
# at about lr each)
MTL_GRAD_ERR, MTL_PARAM_LR = 5e-2, 0.25


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", "0"], capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def cuda_ms(fn, iters=20, warmup=3):
    """Mean ms per call over `iters` calls, by CUDA events."""
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


def paired_ms(kernel_fn, twin_fn, iters, twin_iters=None):
    """Twin, kernel, kernel, twin in one process; mean of each pair."""
    twin_iters = twin_iters or iters
    t1 = cuda_ms(twin_fn, twin_iters, warmup=1)
    k1 = cuda_ms(kernel_fn, iters)
    k2 = cuda_ms(kernel_fn, iters)
    t2 = cuda_ms(twin_fn, twin_iters, warmup=1)
    return (k1 + k2) / 2, (t1 + t2) / 2


def max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(ops: dict, n_bytes: int):
    """(ms, "operations" | "bytes"): the least time the card could take."""
    t_ops = sum(n / PEAK[k] for k, n in ops.items())
    t_bytes = n_bytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def check_close(name, got, ref, atol, rtol):
    import torch
    err = (got.float() - ref.float()).abs()
    lim = atol + rtol * ref.float().abs()
    bad = int((err > lim).sum())
    if bad or not torch.isfinite(got.float()).all():
        raise AssertionError(
            f"{name}: {bad} of {got.numel()} elements outside atol={atol} "
            f"rtol={rtol} (max |Δ| {float(err.max()):.3e})")


def kernel_events(fn, iters):
    """torch.profiler over `iters` calls of fn after one warm-up call:
    ({kernel name: device ms per call}, {name: launches per call}, busy
    device ms per call (the union of the kernel intervals), traced wall ms
    per call). The trace holds the device's activity only: nothing reads
    the host's ops, and tracing them slows the host, which inflates a
    launch-bound run's idle share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / iters * 1e3
    per_name = collections.defaultdict(float)
    count = collections.Counter()
    spans = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        per_name[e.name] += e.time_range.elapsed_us() / 1e3 / iters
        count[e.name] += 1
        spans.append((e.time_range.start, e.time_range.end))
    busy, end = 0.0, None
    for s, e in sorted(spans):               # union of kernel intervals
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return (per_name, {k: n // iters for k, n in count.items()},
            busy / (1e3 * iters), wall)


def device_ms(fn, iters=10):
    """The device time of one call of fn: its kernels' summed durations
    (profiler), free of the host's launch time. A trace with no device
    events (CUPTI dropped them) is taken again, twice at most; then fn is
    timed by CUDA events instead (the host's launch gaps included), and
    the log says so."""
    for _ in range(3):
        ms = sum(kernel_events(fn, iters)[0].values())
        if ms > 0:
            return ms
    ms = cuda_ms(fn, iters)
    print(f"  (the profiler saw no device time three times: {ms:.4f} ms by "
          f"CUDA events)", flush=True)
    return ms


def profile(fn, label, card, iters=3, top=12):
    """Kernel-level device time of fn (torch.profiler): the largest
    kernels, their share, and the device's idle share of the traced wall
    time."""
    per_name, count, busy, wall = kernel_events(fn, iters)
    total = sum(per_name.values())
    print(f"profile {label}: traced wall {wall:.3f} ms, kernels "
          f"{total:.3f} ms, device idle share {1 - busy / wall:.3f} "
          f"[{card}]")
    for name, ms in sorted(per_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {ms:8.3f} ms {100 * ms / total:5.1f}% "
              f"{count[name]:4d}x  {name[:90]}")


class Records:
    """Per-kernel cases: error, kernel / twin / library times, bound."""

    def __init__(self, card):
        self.card = card
        self.rows = {}

    def add(self, key, name, shape, err, kernel_fn, twin_fn, work,
            library=None, iters=20, twin_iters=None, device_time=False,
            nearest=None):
        """work: (ops by type, bytes); library: {label: fn} of PyTorch
        calls, one entry if one call computes the whole function, else
        one per part (labelled part times); a float entry is a time the
        caller measured itself. device_time: also the kernel's device time
        by the profiler (CUDA events time the host's launches where those
        take longer than the kernel). nearest: {label: fn} of one PyTorch
        call that computes a neighbouring function (kept apart from
        library_ms)."""
        import torch
        ms, plain = paired_ms(kernel_fn, twin_fn, iters, twin_iters)
        dev_ms = device_ms(kernel_fn) if device_time else None
        b_ms, b_by = bound(*work)
        lib = {k: f if isinstance(f, float) else cuda_ms(f, iters)
               for k, f in (library or {}).items()}
        near = {k: cuda_ms(f, iters) for k, f in (nearest or {}).items()}
        torch.cuda.synchronize()
        row = self.rows.setdefault(key, {
            "name": name, "route": "cuda", "source": SOURCES[key],
            "replaces": REPLACES[key], "max_abs_err": 0.0, "cases": []})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        case = {"shape": shape, "ms": ms, "plain_ms": plain,
                "bound_ms": b_ms, "bound_by": b_by}
        if dev_ms is not None:
            case["device_ms"] = dev_ms
        if len(lib) == 1 and "part" not in next(iter(lib)):
            case["library_ms"] = next(iter(lib.values()))
        elif lib:
            case["library_part_ms"] = lib
        if near:
            case["nearest_library_ms"] = near
        row["cases"].append(case)
        libs = "  ".join(f"{k} {v:.4f} ms" for k, v in {**lib,
                                                        **near}.items())
        dev = "" if dev_ms is None else f" (device {dev_ms:.4f} ms)"
        print(f"  {key} {name} {shape}: max|Δ| {err:.3e}  kernel {ms:.4f} ms"
              f"{dev}  twin {plain:.4f} ms  bound {b_ms:.4f} ms ({b_by})"
              f"{'  ' + libs if libs else ''}  [{self.card}]", flush=True)

    def note_gemm(self, timed):
        """The int8 GEMM launch alone at I8_PATHS (`i8_gemm_path_timings`)
        into the rows of the kernels it serves: probe 16's k_pure and
        k_noquant, and K1's (QKV, out-projection) and K2's (fc1, fc2)
        products, as device times with their bounds and torch._int_mm's."""
        for label, (ms, b_ms, b_by, lib_ms) in timed.items():
            path = next(p for p in I8_PATHS if p[0] == label)
            key = ("16-pure" if "k_pure" in label else "16-noquant"
                   if "k_noquant" in label else "K1"
                   if label.endswith(("QKV", "out-proj")) else "K2")
            self.rows[key].setdefault("gemm_launch", []).append(
                {"path": label, "shape": path[1:4], "mode": path[4],
                 "device_ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": lib_ms})

    def note_ln(self, timed):
        """K4 alone at LN_SHAPES (`ln_timings`) into its row: device times
        with their bounds and F.layer_norm's."""
        for (rows, w, dt), (ms, b_ms, lib_ms) in timed.items():
            self.rows["K4"].setdefault("device", []).append(
                {"shape": (rows, w), "params": dt, "device_ms": ms,
                 "bound_ms": b_ms, "bound_by": "bytes",
                 "library_ms": lib_ms})

    def line(self, launches):
        kernels = []
        for key, row in self.rows.items():
            r = {k: v for k, v in row.items() if k != "cases"}
            cases = row["cases"]
            n = len(cases)
            r["launches"] = launches[key]
            r["ms"] = sum(c["ms"] for c in cases) / n
            r["plain_ms"] = sum(c["plain_ms"] for c in cases) / n
            r["bound_ms"] = sum(c["bound_ms"] for c in cases) / n
            r["bound_by"] = max(cases, key=lambda c: c["bound_ms"])["bound_by"]
            libs = [c.get("library_ms") for c in cases]
            r["library_ms"] = (None if None in libs else sum(libs) / n)
            r["cases"] = cases
            kernels.append(r)
        return json.dumps({"kernels": kernels})


# the kernels on wgmma and TMA: K9 at head_dim 64, 128 and 256 and K1's
# attention on the 64-, 80-, 128- and 256-wide tiles (attention_sm90.cu's
# forward, by output), both at the wide heads (attention_fwd_wide), K10's
# two passes at 64, 128 and 256 and at the wide heads, kernels 11 and 12
# in bf16 (attention_plain_sm90.cu) on the 64-, 80- and 128-wide tiles,
# the bf16 GEMM of K13, K14 and 15 (bf16_gemm_sm90.cu) in its three
# epilogue modes, the int8 GEMM (int8_gemm_sm90.cu) in its seven slot modes
# (the W8A8 block's four, the probes' three) at tile widths 256 and 128,
# its two f32-residual modes at 128, K5 (its LN-panel instance) and the
# probes' quant-panel instances in their four modes at 256, 9b's main pass
# at head_dim 64 and 128 and kernel 17's (its static instance) at 128
# (attention_i8.cu), K6's cluster tile on the 64-, 128- and 256-wide tiles
# (attention.cu), K7 on the 64- and 128-wide tiles (layer_int8.cu), and
# K1's forward with K9's softmax (K7's split form) at 64, 128, 256 and the
# wide heads
SM90_KERNELS = 56
SM90_NAME = re.compile(r"((?:attention_(?:fwd|bwd_dq|bwd_dkv|plain|i8dyn)"
                       r"(?:_wide)?|bf16_gemm|i8_gemm|attn_out|layer_i8)"
                       r"_sm90)(?:ILi(\d+)E)?(?:Li(\d+)E)?(?:Li(\d)E)?"
                       r"(?:Lb(\d)E)?")
# the int8 GEMM's A operand (its third template argument): 1 K5's LN
# panel, 2 the probes' quant panel (0: by TMA)
SM90_A = {"1": ", LN panel", "2": ", quant panel"}
# the kernels whose SASS holds int8 wgmma (IGMMA); K6 and K7 both kinds
SM90_IGMMA = ("i8_gemm_sm90", "attention_i8dyn_sm90", "attn_out_sm90",
              "layer_i8_sm90")


def sm90_sass_dump():
    """Start `cuobjdump -sass` of the built library in the background, its
    output into a file beside the library (the dump takes tens of seconds;
    phase 2 runs meanwhile): (process, file), or None where the toolkit
    has no cuobjdump."""
    import shutil
    from tpudf_torch.ops import _build
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cuobjdump = shutil.which("cuobjdump") or os.path.join(home, "bin",
                                                          "cuobjdump")
    if not os.path.exists(cuobjdump):
        print(f"  sm90 SASS: cuobjdump absent ({cuobjdump}); HGMMA / "
              f"UTMALDG not counted", flush=True)
        return None
    so = sorted(_build.BUILD_DIR.glob("libtpudf_kernels-*.so"),
                key=os.path.getmtime)[-1]
    out = so.with_suffix(".sass")
    with open(out, "w") as f:
        proc = subprocess.Popen([cuobjdump, "-sass", str(so)], stdout=f,
                                stderr=subprocess.DEVNULL)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, out


def sm90_sass_checks(dump):
    """HGMMA / IGMMA and UTMALDG instructions in each sm90 kernel's SASS
    (the dump `sm90_sass_dump` started)."""
    if dump is None:
        return
    proc, out = dump
    if proc.wait(timeout=300) != 0:
        raise AssertionError(f"cuobjdump -sass exited {proc.returncode}")
    counts, fn = {}, None
    with open(out) as f:
        for line in f:
            if "Function : " in line:
                fn = line.split("Function : ")[1].strip()
                fn = fn if "sm90" in fn else None
                if fn:
                    counts[fn] = [0, 0, 0]
            elif fn is not None:
                counts[fn][0] += "HGMMA" in line
                counts[fn][1] += "IGMMA" in line
                counts[fn][2] += "UTMALDG" in line
    out.unlink()
    if len(counts) != SM90_KERNELS:
        raise AssertionError(f"sm90 kernels in the SASS: {list(counts)}")
    for fn, (hgmma, igmma, utmaldg) in sorted(counts.items()):
        m = SM90_NAME.search(fn)
        args = ", ".join(a for a in m.group(2, 3) if a) + SM90_A.get(
            m.group(4), "") + (", static" if m.group(5) == "1" else "")
        kinds = {"HGMMA": hgmma, "IGMMA": igmma}
        if m.group(1) not in SM90_IGMMA:
            kinds.pop("IGMMA")
        elif m.group(1) not in SM90_IGMMA[2:]:
            kinds.pop("HGMMA")
        print(f"  sm90 SASS {m.group(1)}<{args}>: "
              + ", ".join(f"{k} {v}" for k, v in kinds.items())
              + f", UTMALDG {utmaldg}", flush=True)
        if not all(kinds.values()) or not utmaldg:
            raise AssertionError(f"{fn}: no wgmma or TMA in its SASS")


def sm90_build_checks(card):
    """Phase 1 for the kernels on wgmma and TMA (attention_sm90.cu,
    attention_plain_sm90.cu, bf16_gemm_sm90.cu): no spills in ptxas's
    report and no wgmma serialised, the wrappers' shared-memory functions
    equal to the kernels' (K10's dkv block, kernels 11 and 12 in bf16 and
    f32), and the host's ns to encode one tensor map. Their SASS is
    checked by `sm90_sass_checks`."""
    import torch
    from tpudf_torch.ops import _build
    log = _build.build_log.read_text().splitlines()
    for i, line in enumerate(log):
        if "Compiling entry function" in line and "sm90" in line:
            rest = " ".join(log[i + 1:i + 4])
            if " 0 bytes spill stores" not in rest:
                raise AssertionError(f"ptxas reports spills: {line} {rest}")
        if "C7515" in line:                     # wgmma serialised
            raise AssertionError(f"ptxas: {line.strip()}")
    from tpudf_torch.ops import attention
    lib = _build.load()
    for hd in (64, 128, 256, 384, 1280):
        dkv = {s: lib.tpudf_sm90_smem(2, hd, s)
               for s in (256, 576, 1560, 2048)}
        print(f"  sm90 shared memory a block, head_dim {hd}: K9 "
              f"{lib.tpudf_sm90_smem(0, hd, 0)} B, K10 dq "
              f"{lib.tpudf_sm90_smem(1, hd, 0)} B, dkv {dkv} B (S: bytes)",
              flush=True)
        for s, n in dkv.items():
            if n != attention.sm90_dkv_smem(s, hd):
                raise AssertionError(f"sm90_dkv_smem({s}, {hd}) != {n}")
    plain = {("bf16", d): (lib.tpudf_plain_sm90_smem(d),
                           attention.plain_sm90_smem(d)
                           if attention.plain_fits(torch.bfloat16, d) else -1)
             for d in (32, 64, 72, 96, 128)}
    plain.update({("f32", d): (lib.tpudf_plain_f32_smem(d),
                               attention.plain_f32_smem(d)
                               if attention.plain_fits(torch.float32, d)
                               else -1)
                  for d in (1, 33, 64, 65, 100, 128, 129)})
    print(f"  kernels 11 / 12 shared memory a block ((dtype, head_dim): "
          f"bytes): { {k: v[0] for k, v in plain.items()} }", flush=True)
    for key, (n, want) in plain.items():
        if n != want:
            raise AssertionError(f"kernels 11 / 12 {key}: kernel {n}, "
                                 f"wrapper {want}")
    base = torch.empty(16, device="cuda")
    ns = lib.tpudf_sm90_encode_ns(base.data_ptr(), 2000)
    print(f"  tensor map encode (host, cuTensorMapEncodeTiled through "
          f"cudaGetDriverEntryPoint): {ns} ns a map; K9 encodes 2 (3 with "
          f"the bias), K10 3, kernels 11 / 12 in bf16 4 (8 at head_dim 72), "
          f"the bf16 GEMM 3 (4 with the residual) a launch [{card}]",
          flush=True)


# K9 and K10 at the shapes of the paths that run them (phase 4): qkv's
# (B, S, 3W) (K10's long cases also head_dim) as phases 2, 2b and 2d
# record them
K9_PATHS = [(424, 256, 2304), (106, 576, 3072), (8, 1024, 6144)]
K10_PATHS = [(16, 256, 2304), (16, 576, 3072, 64), (8, 576, 3072, 64)]


def attention_factors(rec, card):
    """Phase 4: K9 and K10 at the paths' shapes beside SDPA's forward and
    backward, and kernels 11 and 12 at every PLAIN_SHAPES case, as phases
    2, 2b, 2c and 2d timed them in this call: the factor kernel / SDPA by
    device time where the profiler measured it (SDPA's backward is device
    time: CUDA events around autograd time the host's call; kernels 11 and
    12 are also given by wall time), and the bound. Raises if a shape was
    not timed."""
    plain = [tuple(s) for s in PLAIN_SHAPES]
    paths_of = {"K9": K9_PATHS, "K10": K10_PATHS, "K11": plain,
                "K12": plain}
    for key, paths in paths_of.items():
        cases = {tuple(c["shape"]): c for c in rec.rows[key]["cases"]}
        for shape in paths:
            c = cases[shape]
            ms = c.get("device_ms", c["ms"])
            lib = c["library_ms"]
            wall = (f", wall {c['ms'] / lib:.2f}x" if key in ("K11", "K12")
                    else "")
            print(f"  {key} {shape}: kernel {c['ms']:.4f} ms"
                  + (f" (device {c['device_ms']:.4f})" if "device_ms" in c
                     else "")
                  + f", SDPA{' backward' if key == 'K10' else ''} "
                  f"{lib:.4f} ms: {ms / lib:.2f}x{wall}; bound "
                  f"{c['bound_ms']:.4f} ms ({c['bound_by']}) [{card}]",
                  flush=True)


def check_launches(label, got, expect):
    if got != expect:
        raise AssertionError(f"{label}: launches {got} != {expect}")


def bf16_step(v):
    """The spacing of bf16 values at magnitude v (one step)."""
    import torch
    return torch.exp2(torch.floor(torch.log2(v.clamp_min(1e-30))) - 7)


def share_apart(a, b):
    """The share of elements of a and b more than one bf16 step apart."""
    import torch
    a, b = a.float(), b.float()
    step = bf16_step(torch.maximum(a.abs(), b.abs()))
    return float(((a - b).abs() > step).float().mean())


def engine_request(label, eng, tw, px, fast, w8a8, expect, width,
                   twin_images=None):
    """One request of a DetectEngine with the launch counts set to 0 just
    before it: exact launches, every output finite and of its shape,
    p_blend / patch_probs / max_patch in [0, 1], max_patch >= patch_mean,
    risk_probs rows summing to 1; then the first `twin_images` images (all
    by default) through the same engine and through its twins: the
    probabilities within 1e-2, the logits z_sig / z_freq within 5e-2 (1e-2
    of probability near 0.5), and the pooled features of every view of
    every tower forward (main and patch views, or the fast pair) cosine >=
    0.99. W8A8: int8 rounding ties move the visual head's output further
    (visual_prob 8.3e-3, z_sig 3.3e-2 on an H100), so its visual_prob and
    z_sig are held at twice those limits. Returns the launches."""
    import numpy as np
    import torch.nn.functional as F
    from tpudf_torch.core.backend import LAUNCHES
    from tpudf_torch.serve.engine import FAST_SCALARS, FULL_SCALARS
    b = px.shape[0]
    LAUNCHES.reset()
    out = eng.fetch_batch(eng.dispatch_batch(px, fast), fast)
    launches = LAUNCHES.snapshot()
    check_launches(f"{label} B={b}", launches, expect)
    names = FAST_SCALARS if fast else FULL_SCALARS
    want = {k: (b,) for k in names}
    want["risk_probs"] = (b, 5)
    if not fast:
        want.update(patch_probs=(b, 16), embed_feat=(b, width))
    shapes = {k: v.shape for k, v in out.items()}
    if shapes != want:
        raise AssertionError(f"{label}: shapes {shapes}")
    for k, v in out.items():
        if not np.isfinite(v).all():
            raise AssertionError(f"{label}: {k} not finite")
    for k in ("p_blend", "patch_probs", "max_patch"):
        if k in out and not ((out[k] >= 0) & (out[k] <= 1)).all():
            raise AssertionError(f"{label}: {k} outside [0,1]")
    if not fast and not (out["max_patch"] >= out["patch_mean"]).all():
        raise AssertionError(f"{label}: max_patch < patch_mean")
    if not np.allclose(out["risk_probs"].sum(-1), 1.0, atol=1e-5):
        raise AssertionError(f"{label}: risk_probs rows do not sum to 1")
    sub = px if twin_images is None else px[:twin_images]
    if twin_images is not None:
        out = eng.fetch_batch(eng.dispatch_batch(sub, fast), fast)
    ref = tw.fetch_batch(tw.dispatch_batch(sub, fast), fast)
    vis = 2.0 if w8a8 else 1.0
    limits = {"p_blend": 1e-2, "visual_prob": 1e-2 * vis,
              "freq_prob": 1e-2, "z_sig": 5e-2 * vis, "z_freq": 5e-2}
    if not fast:
        limits.update(patch_probs=1e-2, max_patch=1e-2, patch_mean=1e-2)
    delta = {k: float(np.abs(out[k] - ref[k]).max()) for k in limits}
    feats_k = eng.pooled_features(sub, fast)
    feats_t = tw.pooled_features(sub, fast)
    cos = {k: float(F.cosine_similarity(feats_k[k].float(),
                                        feats_t[k].float(), dim=-1).min())
           for k in feats_k}
    del feats_k, feats_t
    print(f"{label} B={b}: launches {launches}; vs twins on {sub.shape[0]} "
          f"images: max|Δ| " + ", ".join(f"{k} {v:.3e}"
                                         for k, v in delta.items())
          + "; pooled cosine min "
          + ", ".join(f"{k} {v:.6f}" for k, v in cos.items())
          + f"; p_blend mean {float(out['p_blend'].mean()):.4f}",
          flush=True)
    bad = [k for k, v in delta.items() if v > limits[k]]
    bad += [f"pooled {k}" for k, v in cos.items() if v < 0.99]
    if bad:
        raise AssertionError(f"{label}: kernels vs twins disagree on {bad}")
    return launches


def w8a8_layer(randn, dev, w, heads, hd, inter):
    """Seeded static-W8A8 weights of one layer, head slots padded (heads of
    128 carry so400m's 72 live dims); randn(*shape, std=) draws them."""
    import torch
    from tpudf_torch.convert import add_kernel_layout
    from tpudf_torch.ops.quant import quantize_weight
    wa = heads * hd
    live = 72 if hd == 128 else hd
    # q, k, v of std ~1.5 from the LN output: sharp attention
    qkv_w = randn(w, 3, heads, hd, std=1.5 * w ** -0.5)
    qkv_w[..., live:] = 0.0
    out_w = randn(heads, hd, w, std=wa ** -0.5)
    out_w[:, live:] = 0.0
    qkv_b = randn(3, heads, hd, std=0.1)
    qkv_b[..., live:] = 0.0
    return {
        "ln1": {"scale": 1.0 + randn(w, std=0.1), "bias": randn(w, std=0.1)},
        "qkv_wq": add_kernel_layout(quantize_weight(qkv_w.reshape(w, 3 * wa))),
        "qkv_b": qkv_b.reshape(-1),
        "out_wq": add_kernel_layout(quantize_weight(out_w.reshape(wa, w))),
        "out_b": randn(w, std=0.1),
        "mlp": add_kernel_layout({
            "fc1_w": quantize_weight(randn(w, inter, std=w ** -0.5)),
            "fc1_b": randn(inter, std=0.1),
            "fc2_w": quantize_weight(randn(inter, w, std=inter ** -0.5)),
            "fc2_b": randn(w, std=0.1)}),
        "a_qkv": torch.tensor(4.0, device=dev),
        "a_out": torch.tensor(6.0, device=dev),
        "sc": {"fc1": torch.tensor(4.0, device=dev),
               "fc2": torch.tensor(3.0, device=dev)},
        "live": live}


def sharp_qkv(randn, b, s, heads, hd, live, std=1.5):
    """bf16 qkv of N(0, std^2) in each head's live dims, zero in the padded
    ones: std 1.5 gives scores of std ~2.25, sharp attention; 0.5 is the
    scale of JAX's int8-attention test."""
    import torch
    t = randn(b, s, 3, heads, hd, std=std)
    t[..., live:] = 0.0
    return t.reshape(b, s, 3 * heads * hd).to(torch.bfloat16)


def rel_part(x):
    """|got - twin| / |twin - x|: the error against what the attention
    sublayer adds to its residual x."""
    return lambda got, ref: float((got.float() - ref.float()).norm()
                                  / (ref.float() - x.float()).norm())


def held_check(label, measure, limit, got, ref, faults, card):
    """measure(got, twin) within limit, and beyond it for every planted
    fault's output."""
    sound = measure(got, ref)
    bad = {k: measure(f, ref) for k, f in faults.items()}
    print(f"  {label}: {sound:.3e} (limit {limit:g}); planted faults "
          + ", ".join(f"{k} {v:.3e}" for k, v in bad.items())
          + f" [{card}]", flush=True)
    if sound > limit:
        raise AssertionError(f"{label}: {sound:.3e} > {limit:g}")
    missed = [k for k, v in bad.items() if v <= limit]
    if missed:
        raise AssertionError(f"{label}: the check misses {missed}")


def wrong_scale(hd, scale):
    """The softmax scale taken from the head_dim the kernels see: 128^-0.5
    for so400m's padded heads of 72; at heads of 64, where that is right,
    the same ratio (0.75) off."""
    if scale is not None:
        return hd ** -0.5, "scale 128^-0.5"
    return 0.75 * hd ** -0.5, "scale x0.75"


def large_kernel_checks(rec, dev, card):
    """Phase 2 at the large backbones' shapes: the LN passes at so400m's
    width, K5, K1, K2, K6 and K9 at large-384's S = 576 and so400m-512's
    S = 1024 (heads of 72 zero-padded to 128, scale 72^-0.5), K1 and K2 at
    every token count of large-384's two ToMe schedules (checked, not
    timed), and 9b. The attention inputs are sharp (std 1.5) so that the
    checks of K1, K6, K9 and 9b see the attention; each of them must
    reject planted faults (`held`): the scale taken from the padded
    head_dim, the key bias dropped, 9b's aq over 64-row tiles. 9b is also
    held loosely against K9 at std 0.5, the scale of JAX's bound."""
    import torch
    import torch.nn.functional as F
    from tpudf_torch.ops import attention, int8_block, layernorm, mlp
    from tpudf_torch.ops.routes import KERNELS, TWINS
    from tpudf_torch.ops.tome import (DEPLOYED_PATCH_TOME_R, DEPLOYED_TOME_R,
                                      deployed_floor, deployed_patch_floor,
                                      merge_schedule)

    g = torch.Generator(device=dev).manual_seed(11)
    bf = torch.bfloat16

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=g, device=dev) * std

    def log_sizes(b, s):
        return torch.log(torch.randint(1, 9, (b, s), generator=g,
                                       device=dev).float())

    def layer(name):
        w, heads, hd, _, inter, _ = LARGE[name]
        return w8a8_layer(randn, dev, w, heads, hd, inter)

    def qkv_input(*shape, std=1.5):
        return sharp_qkv(randn, *shape, std=std)

    def held(*args):
        held_check(*args, card)

    print("phase 2b: kernels vs twins at the large backbones", flush=True)
    layers = {name: layer(name) for name in LARGE}

    # K4 and K8 at so400m's width: 1152 = 4.5 chunks of 8 a lane
    w = LARGE["so400m-512"][0]
    ln = layers["so400m-512"]["ln1"]
    x = (randn(8192, w) * 3.0 + 0.5).to(bf)
    got = layernorm.layer_norm_fused(x, ln["scale"], ln["bias"])
    ref = layernorm.layer_norm_reference(x, ln["scale"], ln["bias"])
    torch.cuda.synchronize()
    check_close(f"K4 (8192, {w})", got, ref, atol=1e-6, rtol=2 ** -7)
    g16, b16 = ln["scale"].to(bf), ln["bias"].to(bf)
    rec.add("K4", "layer_norm_fused", (8192, w), max_abs(got, ref),
            lambda: layernorm.layer_norm_fused(x, ln["scale"], ln["bias"]),
            lambda: layernorm.layer_norm_reference(x, ln["scale"],
                                                   ln["bias"]),
            ({"f32": K4_OPS_PER_ELEMENT * x.numel()},
             nbytes(x, ln["scale"], ln["bias"]) + nbytes(got)),
            library={"F.layer_norm": lambda: F.layer_norm(x, (w,), g16, b16,
                                                          1e-6)},
            device_time=True)
    a = torch.tensor(4.0, device=dev)
    got = layernorm.layer_norm_quant(x, ln["scale"], ln["bias"], a)
    ref = layernorm.layer_norm_quant_reference(x, ln["scale"], ln["bias"], a)
    torch.cuda.synchronize()
    dq = (got.int() - ref.int()).abs()
    share = float((dq > 0).float().mean())
    print(f"  K8 (8192, {w}): codes differing from the twin's {share:.3e}, "
          f"max {int(dq.max())} [{card}]", flush=True)
    if int(dq.max()) > 1 or share > K8_SHARE:
        raise AssertionError(f"K8 (8192, {w}): {share:.3e} of the codes "
                             f"differ, max by {int(dq.max())}")
    rec.add("K8", "layer_norm_quant", (8192, w), float(dq.max()),
            lambda: layernorm.layer_norm_quant(x, ln["scale"], ln["bias"],
                                               a),
            lambda: layernorm.layer_norm_quant_reference(
                x, ln["scale"], ln["bias"], a),
            ({"f32": K8_OPS_PER_ELEMENT * x.numel()},
             nbytes(x, ln["scale"], ln["bias"], a) + nbytes(got)),
            library={"part F.layer_norm": lambda: F.layer_norm(
                x, (w,), g16, b16, 1e-6)}, device_time=True)

    for name, (w, heads, hd, scale, inter, s) in LARGE.items():
        p = layers[name]
        wa = heads * hd
        b = 8
        m = b * s
        x = randn(b, s, w).to(bf)
        qkv = qkv_input(b, s, heads, hd, p["live"])
        sd = scale if scale is not None else hd ** -0.5
        bad_sd, bad_name = wrong_scale(hd, scale)
        qv, kv_, vv = (qkv[..., i * wa:(i + 1) * wa].reshape(b, s, heads, hd)
                       .transpose(1, 2) for i in range(3))
        sdpa = lambda mask=None: F.scaled_dot_product_attention(
            qv, kv_, vv, attn_mask=mask, scale=sd)
        # the library's parts: int8 codes at each product's input width
        codes = {k: torch.randint(-127, 128, (m, k), generator=g, device=dev,
                                  dtype=torch.int8) for k in {w, wa, inter}}
        int_mm = lambda k, wq: (lambda: torch._int_mm(codes[k],
                                                      wq["qT"].t()))
        # K5: LN + quant + QKV in one launch, W -> 3 Wa
        args = (x, p["ln1"], p["qkv_wq"], p["qkv_b"], p["a_qkv"])
        got = int8_block.ln_qkv_int8(*args)
        ref = int8_block.ln_qkv_reference(*args)
        torch.cuda.synchronize()
        check_close(f"K5 {(m, w, 3 * wa)}", got, ref, atol=5e-2, rtol=2e-2)
        g16, b16 = p["ln1"]["scale"].to(bf), p["ln1"]["bias"].to(bf)
        y16 = F.layer_norm(x, (w,), g16, b16, 1e-6)
        inv = 127.0 / p["a_qkv"]
        rec.add("K5", "ln_qkv_int8", (m, w, 3 * wa), max_abs(got, ref),
                lambda: int8_block.ln_qkv_int8(*args),
                lambda: int8_block.ln_qkv_reference(*args),
                ({"int8": 2 * m * w * 3 * wa},
                 nbytes(x, p["ln1"]["scale"], p["ln1"]["bias"],
                        p["qkv_wq"]["q"], p["qkv_wq"]["scale"], p["qkv_b"],
                        p["a_qkv"]) + nbytes(got)),
                library={
                    "part F.layer_norm": lambda: F.layer_norm(
                        x, (w,), g16, b16, 1e-6),
                    "part quant": lambda: torch.clamp(
                        torch.round(y16.float() * inv), -127, 127).to(
                            torch.int8),
                    "part QKV _int_mm": int_mm(w, p["qkv_wq"])},
                iters=10, twin_iters=3, device_time=True)
        # K1 (FPP's attention sublayer): without a bias, and at large-384
        # with the ToMe bias too
        for with_bias in ((False, True) if hd == 64 else (False,)):
            lb = log_sizes(b, s) if with_bias else None
            mask = None if lb is None else lb[:, None, None, :].to(bf)
            args = (x, p["ln1"], p["qkv_wq"], p["qkv_b"], p["out_wq"],
                    p["out_b"], p["a_qkv"], p["a_out"], heads, hd, 1e-6,
                    scale)
            live = None if p["live"] == hd else p["live"]   # 80-wide tile
            got = int8_block.attn_sublayer_int8(*args, logit_bias=lb,
                                                live=live)
            ref = int8_block.attn_sublayer_reference(*args, logit_bias=lb)
            faults = {bad_name: int8_block.attn_sublayer_int8(
                *args[:-1], bad_sd, logit_bias=lb, live=live)}
            if with_bias:
                faults["bias dropped"] = int8_block.attn_sublayer_int8(
                    *args, live=live)
            torch.cuda.synchronize()
            check_close(f"K1 {(b, s, w)} bias={with_bias}", got, ref,
                        atol=5e-2, rtol=2e-2)
            held(f"K1 {(b, s, w)} bias={with_bias} |Δ|/|attention part|",
                 rel_part(x), ATTN_REL, got, ref, faults)
            del faults
            rec.add("K1", "attn_sublayer_int8",
                    (b, s, w, "bias" if with_bias else f"d={hd}"),
                    max_abs(got, ref),
                    lambda: int8_block.attn_sublayer_int8(
                        *args, logit_bias=lb, live=live),
                    lambda: int8_block.attn_sublayer_reference(
                        *args, logit_bias=lb),
                    ({"int8": 2 * m * w * 4 * wa,
                      "bf16": 4 * b * heads * s * s * hd},
                     nbytes(x, p["ln1"]["scale"], p["ln1"]["bias"],
                            p["qkv_wq"]["q"], p["qkv_wq"]["scale"],
                            p["qkv_b"], p["out_wq"]["q"],
                            p["out_wq"]["scale"], p["out_b"], p["a_qkv"],
                            p["a_out"], lb) + nbytes(got)),
                    library={
                        "part QKV _int_mm": int_mm(w, p["qkv_wq"]),
                        "part attention SDPA": lambda: sdpa(mask),
                        "part out-proj _int_mm": int_mm(wa, p["out_wq"])},
                    iters=10, twin_iters=2)
        # K2 at the width and MLP of the backbone
        got = mlp.mlp_block_fused_int8(x, p["ln1"], p["mlp"], p["sc"])
        ref = mlp.mlp_block_int8_reference(x, p["ln1"], p["mlp"], p["sc"])
        torch.cuda.synchronize()
        check_close(f"K2 {(m, w, inter)}", got, ref, atol=5e-2, rtol=2e-2)
        mq = p["mlp"]
        rec.add("K2", "mlp_block_fused_int8", (m, w, inter), max_abs(got, ref),
                lambda: mlp.mlp_block_fused_int8(x, p["ln1"], mq, p["sc"]),
                lambda: mlp.mlp_block_int8_reference(x, p["ln1"], mq,
                                                     p["sc"]),
                ({"int8": 4 * m * w * inter},
                 nbytes(x, p["ln1"]["scale"], p["ln1"]["bias"],
                        mq["fc1_w"]["q"], mq["fc1_w"]["scale"], mq["fc1_b"],
                        mq["fc2_w"]["q"], mq["fc2_w"]["scale"], mq["fc2_b"])
                 + nbytes(got)),
                library={"part fc1 _int_mm": int_mm(w, mq["fc1_w"]),
                         "part fc2 _int_mm": int_mm(inter, mq["fc2_w"])},
                iters=10, twin_iters=3)

        if name == "large-384":
            # K6 at (8, 576, 3 x 1024): attention + quant + out-proj in one
            # launch, the int8 o tile beside the streamed K/V ring
            args = (qkv, x, p["out_wq"], p["out_b"], p["a_out"], heads, hd)
            got = int8_block.attn_out_int8(*args)
            ref = int8_block.attn_out_reference(*args)
            bad = int8_block.attn_out_int8(*args, bad_sd)
            torch.cuda.synchronize()
            check_close(f"K6 {(b, s, 3 * wa)}", got, ref, atol=5e-2,
                        rtol=2e-2)
            held(f"K6 {(b, s, 3 * wa)} |Δ|/|attention part|", rel_part(x),
                 ATTN_REL, got, ref, {bad_name: bad})
            del bad
            rec.add("K6", "attn_out_int8", (b, s, 3 * wa), max_abs(got, ref),
                    lambda: int8_block.attn_out_int8(*args),
                    lambda: int8_block.attn_out_reference(*args),
                    ({"bf16": 4 * b * heads * s * s * hd,
                      "int8": 2 * m * wa * w},
                     nbytes(qkv, x, p["out_wq"]["q"], p["out_wq"]["scale"],
                            p["out_b"], p["a_out"]) + nbytes(got)),
                    library={
                        "part attention SDPA": sdpa,
                        "part out-proj _int_mm": int_mm(wa, p["out_wq"])},
                    iters=10, twin_iters=2, device_time=True)
        # K9 at the reference route's (8, 1024, 6144), also with the ToMe
        # bias, and, for large-384, at engine A's full analysis of 2 images
        # (106, 576, 3072)
        if name == "so400m-512":
            lb = log_sizes(b, s)
            got = attention.attention_qkv(qkv, heads, hd, scale,
                                          logit_bias=lb)
            ref = attention.attention_qkv_reference(qkv, heads, hd, scale,
                                                    logit_bias=lb)
            bad = attention.attention_qkv(qkv, heads, hd, scale)
            torch.cuda.synchronize()
            check_close(f"K9 {tuple(qkv.shape)} bias", got, ref, atol=1e-2,
                        rtol=2 ** -7)
            held(f"K9 {tuple(qkv.shape)} bias, share > 1 bf16 step",
                 share_apart, ATTN_SHARE, got, ref, {"bias dropped": bad})
            del lb, bad
        cases = [(qkv, b)]
        if name == "large-384":
            cases = [(qkv_input(2 * VIEWS, s, heads, hd, hd), 2 * VIEWS)]
        for q_in, bb in cases:
            got = attention.attention_qkv(q_in, heads, hd, scale)
            ref = attention.attention_qkv_reference(q_in, heads, hd, scale)
            bad = attention.attention_qkv(q_in, heads, hd, bad_sd)
            torch.cuda.synchronize()
            check_close(f"K9 {tuple(q_in.shape)}", got, ref, atol=1e-2,
                        rtol=2 ** -7)
            held(f"K9 {tuple(q_in.shape)}, share > 1 bf16 step",
                 share_apart, ATTN_SHARE, got, ref, {bad_name: bad})
            del bad
            qs = [q_in[..., i * wa:(i + 1) * wa].reshape(bb, s, heads, hd)
                  .transpose(1, 2) for i in range(3)]
            rec.add("K9", "attention_qkv", tuple(q_in.shape),
                    max_abs(got, ref),
                    lambda: attention.attention_qkv(q_in, heads, hd, scale),
                    lambda: attention.attention_qkv_reference(q_in, heads,
                                                              hd, scale),
                    ({"bf16": 4 * bb * heads * s * s * hd},
                     nbytes(q_in) + nbytes(got)),
                    library={"SDPA": lambda: F.scaled_dot_product_attention(
                        *qs, scale=sd)}, iters=10, twin_iters=2)
        # 9b at (8, S, 3 Wa): by the share of outputs apart from its twin
        # on the sharp qkv, which must reject the twin with aq over 64-row
        # tiles (the CUDA kernel's tile) instead of 256-row blocks, and the
        # wrong scale; there one flipped probability code (a tie) moves an
        # output by up to ap * av / 127 * |v8| / 127, ~3e-2, so the
        # element tolerance holds 9b on qkv of std 0.5, the scale of JAX's
        # bound, where 9b is also held loosely against K9
        got = KERNELS.attention_qkv_int8(qkv, heads, hd, scale)
        ref = TWINS.attention_qkv_int8(qkv, heads, hd, scale)
        faults = {
            "aq over 64-row tiles": attention.attention_qkv_int8_reference(
                qkv, heads, hd, scale, q_block=64),
            bad_name: KERNELS.attention_qkv_int8(qkv, heads, hd, bad_sd)}
        torch.cuda.synchronize()
        held(f"9b {(b, s, 3 * wa)} d={hd}, share > 1 bf16 step",
             share_apart, ATTN_SHARE, got, ref, faults)
        del faults
        q05 = qkv_input(b, s, heads, hd, p["live"], std=0.5)
        got05 = KERNELS.attention_qkv_int8(q05, heads, hd, scale)
        ref05 = TWINS.attention_qkv_int8(q05, heads, hd, scale)
        k9 = attention.attention_qkv(q05, heads, hd, scale)
        torch.cuda.synchronize()
        check_close(f"9b {(b, s, 3 * wa)} at std 0.5", got05, ref05,
                    atol=1e-2, rtol=2 ** -7)
        share = share_apart(got05, ref05)
        cos = float(F.cosine_similarity(got05.float().reshape(-1, wa),
                                        k9.float().reshape(-1, wa),
                                        dim=-1).min())
        rel = max_abs(got05, k9) / float(k9.float().abs().max())
        print(f"  9b {(b, s, 3 * wa)} d={hd} at std 0.5: vs twin more than "
              f"a bf16 step apart {share:.3e}; vs K9 row cosine min "
              f"{cos:.6f}, max|Δ|/max|K9| {rel:.3e} [{card}]", flush=True)
        if share > ATTN_SHARE:
            raise AssertionError(f"9b {(b, s, 3 * wa)} at std 0.5: "
                                 f"{share:.3e} of the outputs differ from "
                                 f"the twin")
        if cos < K9B_COS or rel > K9B_REL:
            raise AssertionError(f"9b vs K9: cosine {cos:.6f}, relative "
                                 f"error {rel:.3e}")
        del q05, got05, ref05, k9
        rec.add("K9b", "attention_qkv_int8", (b, s, 3 * wa),
                max_abs(got, ref),
                lambda: KERNELS.attention_qkv_int8(qkv, heads, hd, scale),
                lambda: TWINS.attention_qkv_int8(qkv, heads, hd, scale),
                ({"int8": 4 * b * heads * s * s * hd},
                 nbytes(qkv) + nbytes(got)),
                library={"SDPA bf16 (nearest one call)": sdpa}, iters=10,
                twin_iters=2, device_time=True)
        del qkv, qv, kv_, vv, got, ref, codes, y16
        torch.cuda.empty_cache()

    # K1 and K2 at every token count of large-384's two ToMe schedules in
    # engine B's full analysis of 8 images: the 168 main views (r=96, floor
    # 72) and the 256 patch views (r=128, floor 36), with a key bias
    w, heads, hd, scale, inter, n = LARGE["large-384"]
    p = layers["large-384"]
    for views, r, floor in ((8 * 21, DEPLOYED_TOME_R, deployed_floor(n)),
                            (8 * 32, DEPLOYED_PATCH_TOME_R,
                             deployed_patch_floor(n))):
        s, errs = n, []
        for ri in (0, *merge_schedule(n, 24, r, floor)):
            s -= ri
            if ri == 0 and s != n:
                continue
            x = randn(views, s, w).to(bf)
            lb = log_sizes(views, s)
            args = (x, p["ln1"], p["qkv_wq"], p["qkv_b"], p["out_wq"],
                    p["out_b"], p["a_qkv"], p["a_out"], heads, hd)
            got = int8_block.attn_sublayer_int8(*args, logit_bias=lb)
            ref = int8_block.attn_sublayer_reference(*args, logit_bias=lb)
            check_close(f"K1 {(views, s, w)} bias", got, ref, atol=5e-2,
                        rtol=2e-2)
            part = rel_part(x)(got, ref)
            if part > ATTN_REL:
                raise AssertionError(f"K1 {(views, s, w)} bias: |Δ|/|"
                                     f"attention part| {part:.3e}")
            errs.append(f"K1 S={s} {max_abs(got, ref):.3e} "
                        f"(|Δ|/|attention part| {part:.3e})")
            got, got_ss = mlp.mlp_block_fused_int8(x, p["ln1"], p["mlp"],
                                                   p["sc"], emit_sumsq=True)
            ref = mlp.mlp_block_int8_reference(x, p["ln1"], p["mlp"],
                                               p["sc"])
            check_close(f"K2 {(views * s, w)} sumsq vs own output", got_ss,
                        torch.sum(got.float() ** 2, dim=-1), 0.0, 1e-4)
            check_close(f"K2 {(views * s, w)}", got, ref, atol=5e-2,
                        rtol=2e-2)
            errs.append(f"K2 {max_abs(got, ref):.3e}")
            del x, lb, got, ref, got_ss
            torch.cuda.empty_cache()
        torch.cuda.synchronize()
        print(f"  large-384 ToMe shapes, {views} views r={r} floor={floor}: "
              f"max|Δ| {'; '.join(errs)} [{card}]", flush=True)


def w8a8_launches(route, layers, merges, *, tome, k6_fits,
                  int8_attn=False):
    """Launches per forward of the static-W8A8 tower at the large
    backbones, by JAX's routing: the detect core with ToMe (K3 and the
    `merges` Σout² forms of K2 included) or the tower alone without it.
    JAX's K7 fits none of them, so LLL runs FPP; under ToMe every layer but the
    first carries the logit bias, which sends P's `attn_out_int8` to its
    reference route (K9 + the out-projection GEMM), as does a geometry
    where K6's estimate does not fit (so400m-512); without a bias that
    route runs 9b under TPUDF_INT8_ATTN=1."""
    from tpudf_torch.ops import (attention, int8_block, layernorm, mlp,
                                 quant, srm)
    n = collections.Counter()
    if route in ("FPP", "LLL"):
        n[int8_block.KERNEL] += layers
        n[mlp.KERNEL] += layers
        n[mlp.KERNEL_SUMSQ] += merges
    elif route == "PPP":
        biased = layers - 1 if tome else 0
        k6 = layers - biased if k6_fits else 0
        n[int8_block.KERNEL_LN_QKV] += layers
        n[int8_block.KERNEL_ATTN_OUT] += k6
        n[attention.KERNEL_INT8 if int8_attn
          else attention.KERNEL] += layers - biased - k6
        n[attention.KERNEL] += biased
        n[quant.KERNEL_GEMM] += layers - k6
        n[mlp.KERNEL] += layers
        n[mlp.KERNEL_SUMSQ] += merges
    else:                                   # XXX
        n[layernorm.KERNEL_QUANT] += 2 * layers
        n[quant.KERNEL_GEMM] += 4 * layers
        n[attention.KERNEL] += layers
    n[layernorm.KERNEL] += 2
    if tome:
        n[srm.KERNEL] += 1
    return {k: v for k, v in n.items() if v}


def pooled_vs(label, kern, twin, pb=None):
    """Pooled cosine of a forward against another (min >= 0.99) and, for
    the detect core, |Δp_blend| <= 1e-2."""
    import torch
    import torch.nn.functional as F
    cos = F.cosine_similarity(kern.float(), twin.float(), dim=-1)
    dpb = 0.0 if pb is None else float((pb[0] - pb[1]).abs().max())
    if not torch.isfinite(kern.float()).all():
        raise AssertionError(f"{label}: pooled not finite")
    if float(cos.min()) < 0.99 or dpb > 1e-2:
        raise AssertionError(f"{label}: kernels vs twins disagree (cosine "
                             f"{float(cos.min()):.6f}, |Δp_blend| "
                             f"{dpb:.3e})")
    return (f"pooled cosine min {float(cos.min()):.6f} mean "
            f"{float(cos.mean()):.6f}; max|Δp_blend| {dpb:.3e}")


def merges(n, layers, r, floor):
    """The ToMe merges of a schedule: the Σout² forms of K2 it launches."""
    from tpudf_torch.ops.tome import merge_schedule
    return sum(1 for ri in merge_schedule(n, layers, r, floor) if ri)


def engine_expect(layers, n):
    """Launches per request of engines A (bf16) and B (W8A8 + ToMe + patch
    ToMe) of a `layers`-deep tower over n tokens, full analysis and fast."""
    from tpudf_torch.ops import (attention, int8_block, layernorm, linear,
                                 mlp, srm)
    from tpudf_torch.ops.tome import (DEPLOYED_PATCH_TOME_R, DEPLOYED_TOME_R,
                                      deployed_floor, deployed_patch_floor)
    floats = {linear.KERNEL: 2 * layers, attention.KERNEL: layers,
              mlp.KERNEL_BF16: layers, layernorm.KERNEL: 2, srm.KERNEL: 1}
    main_m = merges(n, layers, DEPLOYED_TOME_R, deployed_floor(n))
    patch_m = merges(n, layers, DEPLOYED_PATCH_TOME_R,
                     deployed_patch_floor(n))
    return {("A", "full"): floats, ("A", "fast"): floats,
            # two tower forwards: the main views and the patch views
            ("B", "full"): {int8_block.KERNEL: 2 * layers,
                            mlp.KERNEL: 2 * layers,
                            mlp.KERNEL_SUMSQ: main_m + patch_m,
                            layernorm.KERNEL: 4, srm.KERNEL: 1},
            ("B", "fast"): {int8_block.KERNEL: layers, mlp.KERNEL: layers,
                            mlp.KERNEL_SUMSQ: main_m, layernorm.KERNEL: 2,
                            srm.KERNEL: 1}}


def large_paths(dev, card):
    """Phase 3 (e)-(g): the detect core of large-384 and of so400m-512
    (build(cfg_name=...): random weights from seed 0, calibrated on 32
    seeded images, quantised and pre-padded; every layer at full width)
    at B=8 under FPP (the default), PPP, XXX and LLL with the deployed
    ToMe, and the tower without ToMe under each route, so400m-512's PPP
    also with TPUDF_INT8_ATTN=1 (9b); then large-384's engines A (bf16)
    and B (W8A8 + ToMe + patch ToMe): a full analysis of 8 images and a
    fast request of 32, each with exact launches, held against the twins
    on 2 images. Returns what phase 4 times and the launches seen."""
    import dataclasses

    import numpy as np
    import torch
    from tpudf_torch.core.backend import LAUNCHES
    from tpudf_torch.entry import build, build_engine, detect_core
    from tpudf_torch.models.siglip import siglip_forward
    from tpudf_torch.ops import int8_block
    from tpudf_torch.ops.routes import TWINS
    from tpudf_torch.ops.tome import DEPLOYED_TOME_R, deployed_floor

    state = {"cores": {}, "launches": {}}
    pg = torch.Generator(device=dev).manual_seed(6)
    for name, (w, heads, hd, _, _, n) in LARGE.items():
        t0 = time.perf_counter()
        model = build(dev, seed=0, cfg_name=name)
        torch.cuda.synchronize()
        print(f"detect core {name}: build (init + calibrate on 32 images + "
              f"quantise + pre-pad) {time.perf_counter() - t0:.2f} s "
              f"[{card}]", flush=True)
        params, cfg = model.param_tree(), model.cfg
        n_merge = merges(n, cfg.layers, DEPLOYED_TOME_R, deployed_floor(n))
        k6_fits = int8_block.attn_out_int8_fits(n, heads * hd, w, hd)
        px = torch.rand((8, cfg.image_size, cfg.image_size, 3), generator=pg,
                        device=dev).to(torch.bfloat16)
        norm = (px - 0.5) / 0.5
        try:
            for route in ("FPP", "PPP", "XXX", "LLL"):
                os.environ["TPUDF_INT8_KERNELS"] = route
                expect = w8a8_launches(route, cfg.layers, n_merge, tome=True,
                                       k6_fits=k6_fits)
                LAUNCHES.reset()
                out = model(px)
                torch.cuda.synchronize()
                launched = LAUNCHES.snapshot()
                check_launches(f"detect core {name} {route} B=8", launched,
                               expect)
                for k, v in out.items():
                    if not torch.isfinite(v).all():
                        raise AssertionError(f"{name} {route}: {k} not "
                                             f"finite")
                pb = out["p_blend"]
                rs = out["risk_probs"].sum(-1)
                if (tuple(out["risk_probs"].shape) != (8, 5)
                        or not ((pb >= 0) & (pb <= 1)).all()
                        or not torch.allclose(rs, torch.ones_like(rs),
                                              atol=1e-5)):
                    raise AssertionError(f"{name} {route}: outputs out of "
                                         f"range")
                kern = detect_core(params, px, cfg, model.cuts)
                LAUNCHES.reset()
                twin = detect_core(params, px, cfg, model.cuts,
                                   kernels=TWINS)
                torch.cuda.synchronize()
                if LAUNCHES.snapshot():
                    raise AssertionError(f"twins launched "
                                         f"{LAUNCHES.snapshot()}")
                print(f"detect core {name} {route} B=8: launches {launched}; "
                      + pooled_vs(f"detect core {name} {route}",
                                  kern["pooled"], twin["pooled"],
                                  (kern["p_blend"], twin["p_blend"]))
                      + f"; p_blend mean {float(pb.float().mean()):.4f} "
                      f"[{card}]", flush=True)
                state["launches"][(name, route)] = launched
            variants = [("FPP", False), ("PPP", False), ("XXX", False),
                        ("LLL", False)]
            if not k6_fits:
                variants.append(("PPP", True))
            pooled = {}
            for route, int8_attn in variants:
                os.environ["TPUDF_INT8_KERNELS"] = route
                if int8_attn:
                    os.environ["TPUDF_INT8_ATTN"] = "1"
                label = (f"tower {name} {route}"
                         + (" TPUDF_INT8_ATTN=1" if int8_attn else "")
                         + " without ToMe")
                expect = w8a8_launches(route, cfg.layers, 0, tome=False,
                                       k6_fits=k6_fits, int8_attn=int8_attn)
                with torch.no_grad():
                    LAUNCHES.reset()
                    kern = siglip_forward(params["backbone"], norm, cfg)
                    torch.cuda.synchronize()
                    launched = LAUNCHES.snapshot()
                    check_launches(label, launched, expect)
                    twin = siglip_forward(params["backbone"], norm, cfg,
                                          kernels=TWINS)
                pooled[route, int8_attn] = kern["pooled"]
                extra = ""
                if int8_attn:
                    extra = "; vs the K9 route " + pooled_vs(
                        f"{label} vs K9", kern["pooled"],
                        pooled["PPP", False])
                print(f"{label} B=8: launches {launched}; "
                      + pooled_vs(label, kern["pooled"], twin["pooled"])
                      + extra + f" [{card}]", flush=True)
                state["launches"][(name, route, int8_attn)] = launched
                os.environ.pop("TPUDF_INT8_ATTN", None)
        finally:
            os.environ.pop("TPUDF_INT8_KERNELS", None)
            os.environ.pop("TPUDF_INT8_ATTN", None)
        state["cores"][name] = (model, params)
        del out, kern, twin, pooled
        torch.cuda.empty_cache()

    # large-384's engines: 53 views of 576 tokens per image
    name = "large-384"
    w, _, _, _, _, n = LARGE[name]
    t0 = time.perf_counter()
    eng_a = build_engine(dev, seed=0, cfg_name=name)
    eng_b = build_engine(dev, seed=0, cfg_name=name, int8=True, tome=True,
                         patch_tome=True)
    torch.cuda.synchronize()
    print(f"engines {name}: build of A (bf16) and B (init + calibrate on 16 "
          f"images + quantise) {time.perf_counter() - t0:.2f} s [{card}]",
          flush=True)
    layers = eng_a.cfg.layers
    expect = engine_expect(layers, n)
    rng = np.random.default_rng(8)
    size = eng_a.cfg.image_size
    requests = {"full": rng.integers(0, 256, (8, size, size, 3), np.uint8),
                "fast": rng.integers(0, 256, (32, size, size, 3), np.uint8)}
    engines = {"A": eng_a, "B": eng_b}
    for e, eng in engines.items():
        tw = dataclasses.replace(eng, kernels=TWINS)
        for mode, px in requests.items():
            state["launches"][("engine", e, mode)] = engine_request(
                f"engine {e} {name} {mode}", eng, tw, px, mode == "fast",
                e == "B", expect[(e, mode)], w, twin_images=2)
            torch.cuda.empty_cache()
    state["engines"] = (engines, requests)
    return state


def tower_timing(fn, label, card):
    """Phase 4: a tower forward (no grad) by CUDA events and by device
    time (the profiler's kernel sum, free of the host's launch gaps)."""
    import torch

    def fwd():
        with torch.no_grad():
            return fn()

    ms = cuda_ms(fwd, iters=5, warmup=2)
    dev_ms = device_ms(fwd, iters=3)
    print(f"{label}: {ms:.3f} ms, device {dev_ms:.3f} ms [{card}]",
          flush=True)


def large_timings(state, card):
    """Phase 4 at the large backbones: the detect core of large-384 at B=8
    and 128 and of so400m-512 at B=8 and 64 (kernels, and the twins at
    B=8), a profile of each at its larger batch; so400m-512's tower under
    PPP without ToMe, with and without TPUDF_INT8_ATTN=1 (9b or K9), in
    turns; large-384's engines: the full analysis of 8 and the fast
    request of 32."""
    import torch
    from tpudf_torch.entry import detect_core
    from tpudf_torch.models.siglip import siglip_forward
    from tpudf_torch.ops.routes import TWINS

    g = torch.Generator(device="cuda").manual_seed(9)
    for name, batches in (("large-384", (8, 128)), ("so400m-512", (8, 64))):
        model, params = state["cores"][name]
        size = model.cfg.image_size
        for b in batches:
            px = torch.rand((b, size, size, 3), generator=g,
                            device="cuda").to(torch.bfloat16)
            if b == 8:
                k_ms, t_ms = paired_ms(
                    lambda: model(px),
                    lambda: detect_core(params, px, model.cfg, model.cuts,
                                        kernels=TWINS), iters=10,
                    twin_iters=3)
                twin = (f"; twins {t_ms:.3f} ms = {b * 1e3 / t_ms:.1f} "
                        f"img/s")
            else:
                k_ms, twin = cuda_ms(lambda: model(px), iters=5), ""
            print(f"detect core {name} B={b}: kernels {k_ms:.3f} ms = "
                  f"{b * 1e3 / k_ms:.1f} img/s{twin} [{card}]", flush=True)
        profile(lambda: model(px), f"detect core {name} B={batches[-1]}",
                card, iters=2, top=14)
        del px
        lap(f"timing detect core {name}")

    model, params = state["cores"]["so400m-512"]
    norm = torch.rand((8, 512, 512, 3), generator=g, device="cuda").to(
        torch.bfloat16) * 2 - 1

    def tower(int8_attn):
        os.environ["TPUDF_INT8_ATTN"] = "1" if int8_attn else "0"
        with torch.no_grad():
            return siglip_forward(params["backbone"], norm, model.cfg)

    os.environ["TPUDF_INT8_KERNELS"] = "PPP"
    try:
        i8_ms, k9_ms = paired_ms(lambda: tower(True), lambda: tower(False),
                                 iters=5)
    finally:
        os.environ.pop("TPUDF_INT8_KERNELS", None)
        os.environ.pop("TPUDF_INT8_ATTN", None)
    print(f"tower so400m-512 PPP without ToMe B=8: K9 route {k9_ms:.3f} ms, "
          f"TPUDF_INT8_ATTN=1 (9b) {i8_ms:.3f} ms [{card}]", flush=True)

    # large-384's PPP tower without ToMe at B = 8: 24 K6 launches
    model, params = state["cores"]["large-384"]
    size = model.cfg.image_size
    norm = torch.rand((8, size, size, 3), generator=g, device="cuda").to(
        torch.bfloat16) * 2 - 1
    os.environ["TPUDF_INT8_KERNELS"] = "PPP"
    try:
        tower_timing(lambda: siglip_forward(params["backbone"], norm,
                                            model.cfg),
                     "tower large-384 PPP without ToMe B=8", card)
    finally:
        os.environ.pop("TPUDF_INT8_KERNELS", None)

    engines, requests = state["engines"]
    for e, eng in engines.items():
        for mode, px in requests.items():
            fast = mode == "fast"
            ms = cuda_ms(lambda: eng.fetch_batch(eng.dispatch_batch(px, fast),
                                                 fast), iters=3, warmup=1)
            b = px.shape[0]
            print(f"engine {e} large-384 {mode} B={b}: kernels {ms:.3f} ms = "
                  f"{b * 1e3 / ms:.1f} img/s [{card}]", flush=True)


# kernels 11 and 12 at the paths' shapes, (B, H, Sq, Skv, D, dtype): base-256,
# large-384, so400m-512's raw heads of 72, Sq != Skv with ragged keys, a
# single query (over 576 keys, and over 577: a ragged tile of one key), f32
PLAIN_SHAPES = [(8, 12, 256, 256, 64, "bfloat16"),
                (8, 16, 576, 576, 64, "bfloat16"),
                (8, 16, 1024, 1024, 72, "bfloat16"),
                (8, 16, 77, 576, 64, "bfloat16"),
                (4, 16, 577, 1000, 64, "bfloat16"),
                (8, 16, 1, 576, 64, "bfloat16"),
                (8, 16, 1, 577, 64, "bfloat16"),
                (2, 16, 576, 576, 64, "float32")]
PLAIN_KEY_TILE = 64          # the key tile of both kernels (f32 and bf16)


def plain_attention_checks(rec, dev, card):
    """Phase 2c: kernels 11 ((B, H, S, D)) and 12 ((B, S, H, D)) against
    their twins at PLAIN_SHAPES on q, k, v of std 1.5: bf16 within atol
    1e-2 + rtol 2^-7 with at most ATTN_SHARE of the outputs more than one
    bf16 step apart, f32 within atol 5e-4 + rtol 1e-3 (JAX's own bound);
    each check shown to reject planted faults: the softmax scale from the
    padded head_dim (128^-0.5 in place of 72^-0.5; x0.75 at heads of 64),
    the key mask dropped (at Skv = 577 and 1000: the twin over keys padded
    to the kernel's 64-key tile with the last key, unmasked), and for
    kernel 12 the (B, H, S, D) layout's head stride (the twin reading the
    buffer as (B, H, S, D)) and, at head_dim 72, a head read 80 columns
    wide (the twin over 80 columns whose last 8 are the next head's, as a
    map over (H D, S, B) with 80-wide boxes would read them); the gradient
    through `attention` (kernel 11 forward, the twin's VJP backward) against the
    twins' at (2, 16, 576, 576, 64); then kernel, twin and SDPA timed at
    each shape, and the kernel's device time (the host's launch outlasts it
    at the small shapes)."""
    import torch
    import torch.nn.functional as F
    from tpudf_torch.ops import attention

    print("phase 2c: kernels 11 and 12 vs twins", flush=True)
    g = torch.Generator(device=dev).manual_seed(11)

    def rejects(got, ref, dt):
        """(the check rejects got against ref, max|Δ|, share apart)"""
        atol, rtol = (1e-2, 2 ** -7) if dt == torch.bfloat16 else (5e-4, 1e-3)
        err = (got.float() - ref.float()).abs()
        outside = int((err > atol + rtol * ref.float().abs()).sum())
        share = share_apart(got, ref) if dt == torch.bfloat16 else 0.0
        return (outside > 0 or share > ATTN_SHARE
                or not torch.isfinite(got.float()).all()), float(err.max()), \
            share

    def unmasked(twin, q, k, v, scale, axis):
        skv = k.shape[axis]
        pad = -(-skv // PLAIN_KEY_TILE) * PLAIN_KEY_TILE - skv
        idx = torch.cat([torch.arange(skv, device=dev),
                         torch.full((pad,), skv - 1, device=dev)])
        return twin(q, k.index_select(axis, idx), v.index_select(axis, idx),
                    scale)

    def next_head_columns(t_, width):
        """(B, S, H, d) -> (B, S, H, width): each head's row read `width`
        columns wide from the flat buffer (past its d, the next head's
        columns; zeros past the end)."""
        b_, s_, h_, d_ = t_.shape
        flat = torch.nn.functional.pad(t_.reshape(b_, -1), (0, width - d_))
        idx = ((torch.arange(s_ * h_, device=dev) * d_)[:, None]
               + torch.arange(width, device=dev)).reshape(-1)
        return flat[:, idx].reshape(b_, s_, h_, width)

    for b, h, sq, skv, d, dtype in PLAIN_SHAPES:
        dt = getattr(torch, dtype)
        scale = d ** -0.5
        bad_scale, bad_name = ((128 ** -0.5, "scale 128^-0.5") if d == 72
                               else (0.75 * scale, "scale x0.75"))
        for key, bshd in (("K11", False), ("K12", True)):
            shapes = [(b, n, h, d) if bshd else (b, h, n, d)
                      for n in (sq, skv, skv)]
            q, k, v = ((torch.randn(s_, generator=g, device=dev) * 1.5)
                       .to(dt) for s_ in shapes)
            fn = attention.attention_bshd if bshd else attention.attention
            twin = (attention._reference_bshd if bshd
                    else attention.attention_reference)
            got = fn(q, k, v, scale)
            ref = twin(q, k, v, scale)
            faults = {bad_name: twin(q, k, v, bad_scale)}
            if skv in (577, 1000):
                faults["key mask dropped"] = unmasked(
                    twin, q, k, v, scale, 1 if bshd else 2)
            if bshd:
                faults["BHSD head stride"] = twin(
                    *(t.reshape(t.shape[0], h, -1, d).transpose(1, 2)
                      for t in (q, k, v)), scale)
            if bshd and d == 72:
                faults["heads read 80 wide"] = twin(
                    *(next_head_columns(t, 80) for t in (q, k, v)),
                    scale)[..., :d]
            torch.cuda.synchronize()
            label = f"{key} {(b, h, sq, skv, d)} {dtype}"
            bad, err, share = rejects(got, ref, dt)
            caught = {n: rejects(f, ref, dt) for n, f in faults.items()}
            print(f"  {label}: max|Δ| {err:.3e}, share > 1 bf16 step "
                  f"{share:.3e} (limit {ATTN_SHARE:g}); planted faults "
                  + ", ".join(f"{n} max|Δ| {c[1]:.3e} share {c[2]:.3e}"
                              for n, c in caught.items()) + f" [{card}]",
                  flush=True)
            if bad:
                raise AssertionError(f"{label}: kernel vs twin outside the "
                                     f"tolerance")
            missed = [n for n, c in caught.items() if not c[0]]
            if missed:
                raise AssertionError(f"{label}: the check misses {missed}")
            del faults, caught
            heads_first = ((lambda t: t.transpose(1, 2)) if bshd
                           else (lambda t: t))
            rec.add(key, "attention_bshd" if bshd else "attention",
                    (b, h, sq, skv, d, dtype), err,
                    lambda: fn(q, k, v, scale), lambda: twin(q, k, v, scale),
                    ({"bf16" if dt == torch.bfloat16 else "f32":
                      4 * b * h * sq * skv * d}, nbytes(q, k, v, got)),
                    library={"SDPA": lambda: F.scaled_dot_product_attention(
                        heads_first(q), heads_first(k), heads_first(v),
                        scale=scale)}, iters=10, twin_iters=2,
                    device_time=True)
            del q, k, v, got, ref
    # the gradient: kernel 11 forward, the twin's VJP backward
    q, k, v = (torch.randn((2, 16, 576, 64), generator=g, device=dev)
               .requires_grad_() for _ in range(3))
    ct = torch.randn((2, 16, 576, 64), generator=g, device=dev)
    got = torch.autograd.grad(attention.attention(q, k, v), (q, k, v), ct)
    ref = torch.autograd.grad(attention.attention_reference(q, k, v),
                              (q, k, v), ct)
    torch.cuda.synchronize()
    err = max(max_abs(a, b_) for a, b_ in zip(got, ref))
    print(f"  K11 gradient (kernel forward, twin VJP) vs the twins' at (2, "
          f"16, 576, 576, 64) f32: max|Δ| {err:.3e} [{card}]", flush=True)
    if err > 1e-5:
        raise AssertionError(f"K11 gradient: max|Δ| {err:.3e}")
    torch.cuda.empty_cache()


def hf_state_dict(cfg, seed):
    """An HF SiglipVisionModel state dict of `cfg`, built by name in numpy
    f32 in HF's layouts ((out, in) Linear weights, a (W, 3, p, p) conv,
    head.probe (1, 1, W)), from a seed: weights N(0, 1/fan_in), LN scales
    1 + N(0, 0.05²), biases N(0, 0.05²), the position embedding and the
    probe N(0, 0.02²)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    w, m, p = cfg.width, cfg.mlp_dim, cfg.patch_size
    sd = {}

    def n(*shape, std):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    def lin(name, o, i):
        sd[name + ".weight"] = n(o, i, std=i ** -0.5)
        sd[name + ".bias"] = n(o, std=0.05)

    def ln(name):
        sd[name + ".weight"] = 1 + n(w, std=0.05)
        sd[name + ".bias"] = n(w, std=0.05)

    pre = "vision_model."
    sd[pre + "embeddings.patch_embedding.weight"] = n(w, 3, p, p,
                                                      std=(3 * p * p) ** -0.5)
    sd[pre + "embeddings.patch_embedding.bias"] = n(w, std=0.05)
    sd[pre + "embeddings.position_embedding.weight"] = n(cfg.num_patches, w,
                                                         std=0.02)
    for i in range(cfg.layers):
        e = f"{pre}encoder.layers.{i}."
        ln(e + "layer_norm1")
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            lin(e + "self_attn." + proj, w, w)
        ln(e + "layer_norm2")
        lin(e + "mlp.fc1", m, w)
        lin(e + "mlp.fc2", w, m)
    ln(pre + "post_layernorm")
    sd[pre + "head.probe"] = n(1, 1, w, std=0.02)
    sd[pre + "head.attention.in_proj_weight"] = n(3 * w, w, std=w ** -0.5)
    sd[pre + "head.attention.in_proj_bias"] = n(3 * w, std=0.05)
    lin(pre + "head.attention.out_proj", w, w)
    ln(pre + "head.layernorm")
    lin(pre + "head.mlp.fc1", m, w)
    lin(pre + "head.mlp.fc2", w, m)
    return sd


def hf_leaves_held(tree, sd, cfg, label):
    """Every leaf of a converted tree bit-equal to its name-for-name source
    array, transposed as JAX transposes it (Linear (out, in) -> (in, out);
    the conv (W, 3, p, p) -> (p, p, 3, W) flattened; q, k, v concatenated
    along the output columns; the probe (1, 1, W) -> (1, W))."""
    import numpy as np
    import torch
    pre = "vision_model."
    p = cfg.patch_size

    def a(name):
        return sd[pre + name]

    want = {("embed", "kernel"): a("embeddings.patch_embedding.weight")
            .transpose(2, 3, 1, 0).reshape(p * p * 3, cfg.width),
            ("embed", "bias"): a("embeddings.patch_embedding.bias"),
            ("embed", "pos"): a("embeddings.position_embedding.weight"),
            ("post_ln", "scale"): a("post_layernorm.weight"),
            ("post_ln", "bias"): a("post_layernorm.bias"),
            ("head", "probe"): a("head.probe").reshape(1, cfg.width),
            ("head", "in_w"): a("head.attention.in_proj_weight").T,
            ("head", "in_b"): a("head.attention.in_proj_bias"),
            ("head", "out_w"): a("head.attention.out_proj.weight").T,
            ("head", "out_b"): a("head.attention.out_proj.bias"),
            ("head", "ln", "scale"): a("head.layernorm.weight"),
            ("head", "ln", "bias"): a("head.layernorm.bias"),
            ("head", "fc1_w"): a("head.mlp.fc1.weight").T,
            ("head", "fc1_b"): a("head.mlp.fc1.bias"),
            ("head", "fc2_w"): a("head.mlp.fc2.weight").T,
            ("head", "fc2_b"): a("head.mlp.fc2.bias")}
    for i in range(cfg.layers):
        e = f"encoder.layers.{i}."
        sa = e + "self_attn."
        for path, arr in {
                ("ln1", "scale"): a(e + "layer_norm1.weight"),
                ("ln1", "bias"): a(e + "layer_norm1.bias"),
                ("attn", "qkv_w"): np.concatenate(
                    [a(sa + f"{x}_proj.weight").T for x in "qkv"], axis=1),
                ("attn", "qkv_b"): np.concatenate(
                    [a(sa + f"{x}_proj.bias") for x in "qkv"]),
                ("attn", "out_w"): a(sa + "out_proj.weight").T,
                ("attn", "out_b"): a(sa + "out_proj.bias"),
                ("ln2", "scale"): a(e + "layer_norm2.weight"),
                ("ln2", "bias"): a(e + "layer_norm2.bias"),
                ("mlp", "fc1_w"): a(e + "mlp.fc1.weight").T,
                ("mlp", "fc1_b"): a(e + "mlp.fc1.bias"),
                ("mlp", "fc2_w"): a(e + "mlp.fc2.weight").T,
                ("mlp", "fc2_b"): a(e + "mlp.fc2.bias")}.items():
            want[("blocks",) + path + (i,)] = arr
    n = 0
    for path, arr in want.items():
        leaf = tree
        for k in path:
            leaf = leaf[k]
        if not (leaf.dtype == torch.float32 and torch.equal(
                leaf.cpu(), torch.from_numpy(np.ascontiguousarray(arr)))):
            raise AssertionError(f"{label}: leaf {path} is not its source")
        n += 1
    print(f"  {label}: {n} leaves (every layer's) bit-equal to their "
          f"named sources, transposed as JAX transposes them", flush=True)


def sid_folder(root, n, size, seed):
    """A local SID-style dataset ({train,val}/images, masks, labels.csv) of
    n seeded images a split, for the MTL CLI (its loader reads PNGs with
    PIL)."""
    import csv

    import numpy as np
    from PIL import Image
    rng = np.random.default_rng(seed)
    for split in ("train", "val"):
        for sub in ("images", "masks"):
            os.makedirs(os.path.join(root, split, sub), exist_ok=True)
        rows = []
        for i in range(n):
            label, name = i % 3, f"{i}.png"
            Image.fromarray(rng.integers(0, 256, (size, size, 3), np.uint8)) \
                .save(os.path.join(root, split, "images", name))
            if label == 2:
                mask = np.zeros((size, size), np.uint8)
                mask[size // 4:size // 2, size // 4:size // 2] = 255
                Image.fromarray(mask).save(os.path.join(root, split, "masks",
                                                        name))
            rows.append({"name": name, "label": label})
        with open(os.path.join(root, split, "labels.csv"), "w",
                  newline="") as f:
            wr = csv.DictWriter(f, fieldnames=["name", "label"])
            wr.writeheader()
            wr.writerows(rows)


def weights_paths(dev, card, mtl_batches, tmp):
    """Phase 3 (w1)-(w5), each path with the launch counts set to 0 just
    before it and read just after:
    (w1) an HF SiglipVisionModel state dict of large-384 (24 layers, W
    1024, MLP 4096, head.* included), built by name from seed 0 and
    written with torch.save, converted by `python -m
    tpudf_torch.models.convert` in a subprocess: kind hf, config.json
    exactly CONFIGS["large-384"], every restored leaf bit-equal to
    `from_hf_state_dict` of the same dict and to its named source; then
    `build_engine(cfg_name="large-384", backbone_ckpt=...)` A (bf16) and B
    (W8A8 + ToMe + patch ToMe): a full analysis of 8 each, exact
    launches, held against the twins on 2 images;
    (w2) the MTL trainer from that file at the CLI's defaults
    (large-384 at 256 px: a 16 x 16 grid on the 24 x 24 position table,
    freeze_below 21, taps (2, 6, 10, -1), embed_dim 256, B = 16), float
    (a) and int8 (b) prefix, LARGE_STEPS steps each against the twins
    (every trainer from a copy of one tree read from the file): |Δloss|,
    the step-1 gradient cosine per group, frozen parameters bit-identical,
    exact launches (K10 at (16, 256, 3072) on the 3 trainable layers), and
    on (a) also phase 3 (d)'s per-slice limits;
    `interpolate_pos` at W = 1024 held to a float64 evaluation of the same
    matrices (1e-5 relative); the CLI's main (in this process) for one
    step where PIL imports;
    (w3) the multi-query `_mha` at full width (large-384's MAP-head
    projections on (8, 576, 1024) tokens, and so400m's width on (8, 1024,
    1152), heads of 72): one launch of kernel 11 each against the twins,
    and the same projections in (B, S, H, D) through kernel 12;
    (w4) so400m-512's engines A and B (build_engine(cfg_name=
    "so400m-512")): a full analysis of 8 and a fast request of 32 each,
    exact launches (K14 at hidden 4352), twins on 2 images;
    (w5) so400m-512's dynamic-int8 tower (quantize_siglip(params, cfg)) at
    B = 8 without ToMe against the twins (pooled cosine >= 0.99), and a
    static tree quantised without cfg against the pre-padded one, bit for
    bit. Returns what phase 4 times and the launches seen."""
    import dataclasses
    import json

    import numpy as np
    import torch
    from tpudf_torch.convert import add_kernel_layout
    from tpudf_torch.core.backend import LAUNCHES
    from tpudf_torch.core.precision import tree_map
    from tpudf_torch.entry import build_engine, build_mtl_trainer, mtl_params
    from tpudf_torch.models import siglip as S
    from tpudf_torch.models.convert import from_hf_state_dict
    from tpudf_torch.ops import (attention, int8_block, layernorm, linear,
                                 mlp, quant)
    from tpudf_torch.ops.routes import KERNELS, TWINS
    from tpudf_torch.train.checkpoint import restore_checkpoint

    root = os.path.dirname(os.path.abspath(__file__))
    state = {"launches": {}}
    name = "large-384"
    cfg = S.CONFIGS[name]
    print("phase 3w: weights in, large-384 MTL at 256 px, multi-query "
          "_mha, so400m's engines and int8 trees", flush=True)

    # ---- (w1) weights in
    t0 = time.perf_counter()
    sd = hf_state_dict(cfg, 0)
    pt = os.path.join(tmp, "siglip_large_384.pt")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pt)
    n_params = sum(v.size for v in sd.values())
    print(f"w1: HF state dict of {name} ({len(sd)} tensors, "
          f"{n_params / 1e6:.1f}M values, {os.path.getsize(pt) / 2**30:.2f} "
          f"GiB) built and written in {time.perf_counter() - t0:.2f} s",
          flush=True)
    out_dir = os.path.join(tmp, "converted")
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "tpudf_torch.models.convert",
                          "--src", pt, "--out", out_dir], cwd=root,
                         capture_output=True, text=True, timeout=900)
    convert_s = time.perf_counter() - t0
    if run.returncode != 0:
        raise AssertionError(f"convert failed: {run.stderr[-4000:]}")
    print(f"w1: {run.stdout.strip()} in {convert_s:.2f} s (a subprocess)",
          flush=True)
    side = json.load(open(os.path.join(out_dir, "config.json")))
    if (side["kind"] != "hf" or "[convert] kind=hf" not in run.stdout
            or S.SigLIPConfig(**side["backbone"]) != cfg):
        raise AssertionError(f"w1: config.json {side}")
    restored = restore_checkpoint(os.path.join(out_dir, "params"))
    direct = from_hf_state_dict(sd, cfg)
    flat_r, flat_d = [], []

    def flat(tree, out, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                flat(v, out, path + (k,))
            else:
                out.append((path + (k,), v))

    flat(restored, flat_r)
    flat(direct, flat_d)
    if [p for p, _ in flat_r] != [p for p, _ in flat_d] or not all(
            torch.equal(a, b) for (_, a), (_, b) in zip(flat_r, flat_d)):
        raise AssertionError("w1: the restored checkpoint differs from "
                             "from_hf_state_dict of the same dict")
    print(f"w1: config.json is CONFIGS[{name!r}]; {len(flat_r)} restored "
          f"leaves bit-equal to from_hf_state_dict", flush=True)
    hf_leaves_held(restored, sd, cfg, "w1 restored checkpoint")
    del restored, flat_r, flat_d
    state["head"] = direct["head"]
    # the full analysis of 8 (large-384's fast request runs in phase 3 (g)
    # on the same config)
    rng = np.random.default_rng(12)
    requests = {"full": rng.integers(0, 256, (8, cfg.image_size,
                                              cfg.image_size, 3), np.uint8)}
    expect = engine_expect(cfg.layers, cfg.num_patches)
    for e, kw in (("A", {}), ("B", {"int8": True, "tome": True,
                                    "patch_tome": True})):
        t0 = time.perf_counter()
        eng = build_engine(dev, seed=0, cfg_name=name, backbone_ckpt=pt, **kw)
        torch.cuda.synchronize()
        print(f"w1: build_engine({name!r}, backbone_ckpt=...) {e} in "
              f"{time.perf_counter() - t0:.2f} s (reading the file, "
              f"{'calibrating, quantising, ' if e == 'B' else ''}loading "
              f"onto the card) [{card}]", flush=True)
        if not torch.equal(eng.backbone["embed"]["pos"].cpu(),
                           direct["embed"]["pos"]):
            raise AssertionError("w1: the engine's tower is not the file's")
        tw = dataclasses.replace(eng, kernels=TWINS)
        for mode, px in requests.items():
            state["launches"][("w1", e, mode)] = engine_request(
                f"w1 engine {e} {name} from the checkpoint {mode}", eng, tw,
                px, mode == "fast", e == "B", expect[(e, mode)], cfg.width,
                twin_images=2)
        del eng, tw
        torch.cuda.empty_cache()
    del direct
    lap("w1")

    # ---- (w2) large-384 MTL at 256 px from the file
    pos = S.interpolate_pos(
        torch.from_numpy(sd["vision_model.embeddings.position_embedding"
                            ".weight"]).to(dev), cfg.grid, (16, 16))
    mh, mw = S._bicubic_matrix(cfg.grid, 16), S._bicubic_matrix(cfg.grid, 16)
    grid64 = sd["vision_model.embeddings.position_embedding.weight"].astype(
        np.float64).reshape(cfg.grid, cfg.grid, cfg.width)
    ref = np.einsum("kj,ijc->ikc", mw, np.einsum("ij,jkc->ikc", mh, grid64))
    rel = float(np.abs(pos.cpu().double().numpy() - ref.reshape(256, -1))
                .max() / np.abs(ref).max())
    print(f"w2: interpolate_pos 24x24 -> 16x16 at W = {cfg.width} on the "
          f"card vs float64: max|Δ| / max|ref| {rel:.3e} (limit 1e-5) "
          f"[{card}]", flush=True)
    if rel > 1e-5:
        raise AssertionError(f"w2: interpolate_pos {rel:.3e}")
    del sd, pos
    freeze, layers = 21, cfg.layers
    # the file read once: every trainer below starts from a copy of it
    w2_tree = mtl_params(dev, seed=0, cfg_name=name, backbone_ckpt=pt)
    batches = mtl_batches[:LARGE_STEPS]

    def make(cfg_key, ks=KERNELS):
        return build_mtl_trainer(
            fresh(w2_tree), cfg_name=name, image_size=256,
            freeze_below=freeze, seg_layers=(2, 6, 10, -1), embed_dim=256,
            int8_frozen=cfg_key == "b", lr=MTL_LR, warmup_steps=1,
            calib_pixels=mtl_batches[0]["pixels"], kernels=ks)

    trainable = layers - freeze
    w2_expect = {
        "a": {linear.KERNEL: 2 * layers, attention.KERNEL: layers,
              mlp.KERNEL_BF16: layers, layernorm.KERNEL: 2,
              attention.KERNEL_BWD: trainable},
        "b": {int8_block.KERNEL: freeze, mlp.KERNEL: freeze,
              linear.KERNEL: 2 * trainable, attention.KERNEL: trainable,
              mlp.KERNEL_BF16: trainable, layernorm.KERNEL: 2,
              attention.KERNEL_BWD: trainable}}
    for cfg_key in ("a", "b"):
        label = f"w2 {name} 256 px ({cfg_key})"
        kern = train_run(make, cfg_key, KERNELS, f"{label} kernels",
                         batches, freeze, dev, card)
        for i, launches in enumerate(kern[3]):
            check_launches(f"{label} step {i}", launches, w2_expect[cfg_key])
        twin = train_run(make, cfg_key, TWINS, f"{label} twins", batches,
                         freeze, dev, card)
        if any(twin[3]):
            raise AssertionError(f"twins launched {twin[3]}")
        dloss, cos, g_worst, p_worst = versus(kern, twin)
        print(f"{label}: launches per step {kern[3][0]} (K10 at (16, 256, "
              f"3072))", flush=True)
        print(report(label, dloss, cos, g_worst, p_worst, card), flush=True)
        # (b): the per-slice limits of phase 3 (d) are held on (a), where
        # they isolate K10 and the float kernels; in (b) the 21 frozen
        # layers' int8 ties (K1 quantises the f32 attention output, its
        # twin the bf16-rounded one) move every tap the trainable layers
        # read, and the slices are reported, not held (6.9e-2 measured)
        slices_ok = g_worst[1] <= MTL_GRAD_ERR and p_worst[1] <= MTL_PARAM_LR
        if (max(dloss) > MTL_DLOSS[cfg_key] or min(cos.values()) < 0.99
                or (cfg_key == "a" and not slices_ok)):
            raise AssertionError(f"{label}: kernels vs twins disagree")
        state["launches"][("w2", cfg_key)] = kern[3][0]
        del kern, twin
        torch.cuda.empty_cache()
        lap(f"w2 ({cfg_key})")
    state["mtl"] = make
    try:
        import PIL  # noqa: F401
        has_pil = True
    except ImportError:
        has_pil = False
    print(f"w2: PIL {'imports' if has_pil else 'does not import'} here",
          flush=True)
    if has_pil:
        # the CLI's main in this process (phase 3 (s) launches the CLI as a
        # process of its own): the production run's arguments
        from tpudf_torch.cli import train_mtl
        data = os.path.join(tmp, "sid")
        sid_folder(data, 16, 300, 13)
        t0 = time.perf_counter()
        train_mtl.main(["--model_size", name, "--backbone_ckpt", pt,
                        "--data_dir", data, "--save_dir",
                        os.path.join(tmp, "mtl_run"), "--epochs", "1",
                        "--batch_size", "16", "--device", "cuda"])
        torch.cuda.synchronize()
        rows = open(os.path.join(tmp, "mtl_run",
                                 "training_log.csv")).read().splitlines()
        if len(rows) != 2:
            raise AssertionError(f"w2 CLI: training log {rows}")
        print(f"w2: tpudf_torch.cli.train_mtl.main(--model_size {name} "
              f"--backbone_ckpt ...) (image_size 256, 16 images, one step, "
              f"eval, checkpoint) in {time.perf_counter() - t0:.2f} s; log "
              f"{rows[1][:160]} [{card}]", flush=True)
        torch.cuda.empty_cache()
        lap("w2 CLI")

    # ---- (w3) the multi-query _mha at full width
    g = torch.Generator(device=dev).manual_seed(14)
    so = "so400m-512"
    scfg = S.CONFIGS[so]
    for label, c_, hp in ((f"{name} MAP-head projections", cfg,
                           state["head"]),
                          (f"{so} width, heads of 72", scfg, None)):
        w, heads, s_ = c_.width, c_.heads, c_.num_patches
        if hp is None:
            hp = {"in_w": torch.randn((w, 3 * w), generator=g, device=dev)
                  * w ** -0.5,
                  "in_b": torch.randn(3 * w, generator=g, device=dev) * 0.05,
                  "out_w": torch.randn((w, w), generator=g, device=dev)
                  * w ** -0.5,
                  "out_b": torch.randn(w, generator=g, device=dev) * 0.05}
        args = [hp[k].to(dev, torch.bfloat16)
                for k in ("in_w", "in_b", "out_w", "out_b")]
        x = torch.randn((8, s_, w), generator=g, device=dev).to(
            torch.bfloat16)
        LAUNCHES.reset()
        got = S._mha(x, x, heads, *args)
        d = w // heads
        proj = (x @ args[0] + args[1]).reshape(8, s_, 3, heads, d)
        o_bshd = attention.attention_bshd(*(proj[:, :, i].contiguous()
                                            for i in range(3)))
        torch.cuda.synchronize()
        launched = LAUNCHES.snapshot()
        check_launches(f"w3 _mha {label}", launched,
                       {attention.KERNEL_PLAIN: 1, attention.KERNEL_BSHD: 1})
        ref = S._mha(x, x, heads, *args, kernels=TWINS)
        o_ref = attention._reference_bshd(*(proj[:, :, i] for i in range(3)))
        torch.cuda.synchronize()
        check_close(f"w3 _mha {label}", got, ref, atol=1e-2, rtol=2 ** -7)
        check_close(f"w3 kernel 12 {label}", o_bshd, o_ref, atol=1e-2,
                    rtol=2 ** -7)
        sh = (share_apart(got, ref), share_apart(o_bshd, o_ref))
        print(f"w3 _mha(x, x, {heads}, ...) {label}, x {tuple(x.shape)}: "
              f"launches {launched}; vs twins max|Δ| {max_abs(got, ref):.3e}"
              f", share > 1 bf16 step {sh[0]:.3e}; kernel 12 on the (B, S, "
              f"H, D) projections max|Δ| {max_abs(o_bshd, o_ref):.3e}, share "
              f"{sh[1]:.3e} [{card}]", flush=True)
        if max(sh) > ATTN_SHARE:
            raise AssertionError(f"w3 {label}: share {sh}")
        state["launches"][("w3", c_.width)] = launched
        del x, got, ref, proj, o_bshd, o_ref
    torch.cuda.empty_cache()
    lap("w3")

    # ---- (w4) so400m-512's engines
    rng = np.random.default_rng(15)
    so_requests = {m_: rng.integers(0, 256, (b, scfg.image_size,
                                             scfg.image_size, 3), np.uint8)
                   for m_, b in (("full", 8), ("fast", 32))}
    expect = engine_expect(scfg.layers, scfg.num_patches)
    engines = {}
    for e, kw in (("A", {}), ("B", {"int8": True, "tome": True,
                                    "patch_tome": True})):
        t0 = time.perf_counter()
        eng = build_engine(dev, seed=0, cfg_name=so, **kw)
        torch.cuda.synchronize()
        hidden = (eng.tower["blocks"]["mlp"]["fc1_w"]["q"] if e == "B"
                  else eng.tower["blocks"]["mlp"]["fc1_w"]).shape[-1]
        print(f"w4: build_engine({so!r}) {e} in "
              f"{time.perf_counter() - t0:.2f} s; the tower's MLP hidden "
              f"{hidden} [{card}]", flush=True)
        if hidden != 4352:
            raise AssertionError(f"w4 engine {e}: MLP hidden {hidden}")
        tw = dataclasses.replace(eng, kernels=TWINS)
        for mode, px in so_requests.items():
            state["launches"][("w4", e, mode)] = engine_request(
                f"w4 engine {e} {so} {mode}", eng, tw, px, mode == "fast",
                e == "B", expect[(e, mode)], scfg.width, twin_images=2)
            torch.cuda.empty_cache()
        engines[e] = eng
        del tw
    state["so400m engines"] = (engines, so_requests)
    lap("w4")

    # ---- (w5) so400m-512's dynamic-int8 tower, an un-prepadded static tree
    p = tree_map(lambda t: t.to(dev),
                 S.init_siglip(torch.Generator().manual_seed(16), scfg))
    norm = torch.rand((8, 512, 512, 3), generator=g, device=dev) * 2 - 1
    dyn = add_kernel_layout(quant.quantize_siglip(p, scfg))
    with torch.no_grad():
        LAUNCHES.reset()
        kern = S.siglip_forward(dyn, norm, scfg)
        torch.cuda.synchronize()
        launched = LAUNCHES.snapshot()
        check_launches("w5 dynamic-int8 tower so400m-512", launched,
                       {quant.KERNEL_GEMM: 4 * scfg.layers,
                        attention.KERNEL: scfg.layers,
                        layernorm.KERNEL: 2 * scfg.layers + 2})
        twin = S.siglip_forward(dyn, norm, scfg, kernels=TWINS)
    print(f"w5 dynamic-int8 tower {so} (pre-padded once: heads 72 -> 128, "
          f"MLP 4304 -> 4352) B=8 without ToMe: launches {launched}; "
          + pooled_vs("w5 dynamic", kern["pooled"], twin["pooled"])
          + f" [{card}]", flush=True)
    state["launches"]["w5"] = launched
    del dyn, kern, twin
    scales = quant.calibrate_siglip_act_scales(p, scfg, norm)
    trees = [add_kernel_layout(quant.quantize_siglip_static(p, scales, c))
             for c in (None, scfg)]
    with torch.no_grad():
        outs = [S.siglip_forward(t, norm, scfg) for t in trees]
    torch.cuda.synchronize()
    same = all(torch.equal(outs[0][k], outs[1][k])
               for k in ("tokens", "pooled"))
    print(f"w5 static tree quantised without cfg (padded in the graph) vs "
          f"the pre-padded tree, B=8 without ToMe: tokens and pooled "
          f"bit-equal {same} [{card}]", flush=True)
    if not same:
        raise AssertionError("w5: the un-prepadded static tree differs")
    del p, trees, outs, norm
    torch.cuda.empty_cache()
    return state


def weights_timings(state, card, mtl_batches):
    """Phase 4 of the (w) paths: the large-384 MTL step at 256 px from the
    checkpoint, (a) and (b), kernels vs twins, with a profile of (a); and
    so400m-512's engines A and B, full analysis of 8 and fast 32."""
    import torch
    from tpudf_torch.ops.routes import TWINS

    def run(box):
        box["state"], _ = box["step"](box["state"], mtl_batches[0], None,
                                      1.0, 0.5)

    for cfg_key in ("a", "b"):
        boxes = {}
        for label, ks in (("kernels", None), ("twins", TWINS)):
            st, step, _ = (state["mtl"](cfg_key) if ks is None
                           else state["mtl"](cfg_key, ks))
            boxes[label] = {"state": st, "step": step}
        k_ms, t_ms = paired_ms(lambda: run(boxes["kernels"]),
                               lambda: run(boxes["twins"]), iters=5,
                               twin_iters=3)
        print(f"w2 train step large-384 256 px ({cfg_key}) B={MTL_BATCH}: "
              f"kernels {k_ms:.3f} ms = {MTL_BATCH * 1e3 / k_ms:.1f} img/s; "
              f"twins {t_ms:.3f} ms [{card}]", flush=True)
        if cfg_key == "a":
            profile(lambda: run(boxes["kernels"]),
                    f"w2 train step large-384 256 px (a) B={MTL_BATCH}",
                    card, top=14)
        del boxes
        torch.cuda.empty_cache()
        lap(f"timing w2 ({cfg_key})")
    engines, requests = state["so400m engines"]
    for e, eng in engines.items():
        for mode, px in requests.items():
            fast = mode == "fast"
            ms = cuda_ms(lambda: eng.fetch_batch(eng.dispatch_batch(px, fast),
                                                 fast), iters=3, warmup=1)
            b = px.shape[0]
            print(f"w4 engine {e} so400m-512 {mode} B={b}: kernels "
                  f"{ms:.3f} ms = {b * 1e3 / ms:.1f} img/s [{card}]",
                  flush=True)


# K10 past S = 256 and at head_dim 128 (phase 2d): (B, S, heads, head_dim,
# scale): large-384's MTL step at 384 px and its binary trainer with the
# tower trained (S = 576, heads of 64), a narrow S = 1024, heads of 128
# (so400m's 72 padded, scale 72^-0.5, the padded dims zero) and a ragged S
# (a multiple of 8, not of the 64-key tile)
K10_LONG = [(16, 576, 16, 64, None), (8, 576, 16, 64, None),
            (4, 1024, 2, 64, None), (8, 512, 8, 128, 72 ** -0.5),
            (2, 1000, 2, 64, None)]


def k10_twin_fault(qkv, g, heads, hd, scale, fault):
    """K10's twin with a planted fault: "D" drops D = rowsum(dP * P);
    "unmasked" lets the keys past S into the softmax as the kernel's ring
    holds them (row S - 1 repeated up to the 64-key tile)."""
    import torch
    b, s, w3 = qkv.shape
    w = w3 // 3
    k, v = qkv[..., w:2 * w], qkv[..., 2 * w:]
    sp = s
    if fault == "unmasked":
        sp = -(-s // 64) * 64
        k = torch.cat([k, k[:, -1:].expand(b, sp - s, w)], 1)
        v = torch.cat([v, v[:, -1:].expand(b, sp - s, w)], 1)

    def hf(t, n):
        return t.reshape(b, n, heads, hd).transpose(1, 2).float()

    q, k, v, gh = hf(qkv[..., :w], s), hf(k, sp), hf(v, sp), hf(g, s)
    p = torch.softmax(q @ k.transpose(-1, -2) * scale, dim=-1)
    dv = p.bfloat16().float().transpose(-1, -2) @ gh
    dp = gh @ v.transpose(-1, -2)
    d = 0.0 if fault == "D" else torch.sum(dp * p, -1, keepdim=True)
    ds = (p * (dp - d) * scale).bfloat16().float()
    dq, dk = ds @ k, ds.transpose(-1, -2) @ q
    return torch.cat([t[:, :, :s].transpose(1, 2).reshape(b, s, w)
                      for t in (dq, dk, dv)], -1).bfloat16()


def k10_agrees(got, ref):
    """(within atol 1e-2 + rtol 2^-7, share more than a bf16 step apart)."""
    err = (got.float() - ref.float()).abs()
    ok = bool((err <= 1e-2 + 2 ** -7 * ref.float().abs()).all())
    return ok, share_apart(got, ref)


def k10_long_checks(rec, dev, card):
    """Phase 2d: K10 at K10_LONG on q, k, v of std 1.5 against its twin
    (atol 1e-2 + rtol 2^-7, at most ATTN_SHARE of the outputs more than a
    bf16 step apart), one launch each; each check shown to fail on planted
    faults: the scale from the padded head_dim (at heads of 64 the same
    0.75 ratio), the D term dropped, and at the ragged S the keys past S
    unmasked; kernel, twin and SDPA's backward timed. Then JAX's route at
    so400m-512's padded heads, (16, 1024, 6144) with d = 128 and JAX's 72:
    no K10 launch, the twin's VJP counted once."""
    import torch
    import torch.nn.functional as F
    from tpudf_torch.core.backend import LAUNCHES
    from tpudf_torch.ops import attention
    print("phase 2d: K10 past S = 256 and at head_dim 128", flush=True)
    g = torch.Generator(device=dev).manual_seed(21)
    for b, s, heads, hd, scale in K10_LONG:
        w = heads * hd
        qkv = torch.randn((b, s, 3, heads, hd), generator=g,
                          device=dev) * 1.5
        if scale is not None:                 # so400m's zero padded dims
            qkv[..., 72:] = 0.0
        qkv = qkv.reshape(b, s, 3 * w).to(torch.bfloat16)
        gout = torch.randn((b, s, w), generator=g, device=dev).to(
            torch.bfloat16)
        sc = scale if scale is not None else hd ** -0.5
        LAUNCHES.reset()
        got = attention.attention_qkv_bwd(qkv, gout, heads, hd, scale)
        torch.cuda.synchronize()
        check_launches(f"K10 {(b, s, 3 * w)}", LAUNCHES.snapshot(),
                       {attention.KERNEL_BWD: 1})
        ref = attention.attention_qkv_bwd_reference(qkv, gout, heads, hd,
                                                    scale)
        ok, share = k10_agrees(got, ref)
        bad_scale = hd ** -0.5 if scale is not None else 0.75 * sc
        faults = {"scale": k10_agrees(attention.attention_qkv_bwd(
                      qkv, gout, heads, hd, bad_scale), ref),
                  "D dropped": k10_agrees(got, k10_twin_fault(
                      qkv, gout, heads, hd, sc, "D"))}
        if s % 64:
            faults["keys unmasked"] = k10_agrees(got, k10_twin_fault(
                qkv, gout, heads, hd, sc, "unmasked"))
        print(f"  K10 {(b, s, 3 * w)} d {hd} scale {sc:.5f}: max|Δ| "
              f"{max_abs(got, ref):.3e}, share > 1 bf16 step {share:.3e}; "
              "planted faults: " + ", ".join(
                  f"{k} {'within' if o and sh <= ATTN_SHARE else 'caught'} "
                  f"(share {sh:.4f})" for k, (o, sh) in faults.items())
              + f" [{card}]", flush=True)
        if not ok or share > ATTN_SHARE:
            raise AssertionError(f"K10 {(b, s, 3 * w)} vs twin: share "
                                 f"{share:.3e}")
        missed = [k for k, (o, sh) in faults.items()
                  if o and sh <= ATTN_SHARE]
        if missed:
            raise AssertionError(f"K10 {(b, s, 3 * w)}: the check misses "
                                 f"{missed}")
        qv, kv_, vv = (qkv[..., i * w:(i + 1) * w].reshape(b, s, heads, hd)
                       .transpose(1, 2).detach().requires_grad_(True)
                       for i in range(3))
        go = gout.reshape(b, s, heads, hd).transpose(1, 2)

        def sdpa_fwd():
            return F.scaled_dot_product_attention(qv, kv_, vv, scale=sc)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa_fwd(), (qv, kv_, vv), go)

        sdpa_bwd = device_ms(sdpa_fwd_bwd) - device_ms(sdpa_fwd)
        rec.add("K10", "attention_qkv_bwd", (b, s, 3 * w, hd),
                max_abs(got, ref),
                lambda: attention.attention_qkv_bwd(qkv, gout, heads, hd,
                                                    scale),
                lambda: attention.attention_qkv_bwd_reference(
                    qkv, gout, heads, hd, scale),
                ({"bf16": 5 * 2 * s * s * hd * heads * b},
                 nbytes(qkv, gout) + nbytes(got)),
                library={"SDPA backward": sdpa_bwd}, iters=10,
                twin_iters=3, device_time=True)
        del qkv, gout, got, ref, qv, kv_, vv, go, faults
        torch.cuda.empty_cache()
    # JAX's route at so400m-512's padded heads: its fit fails
    qkv = torch.randn((16, 1024, 6144), generator=g, device=dev).to(
        torch.bfloat16)
    gout = torch.randn((16, 1024, 2048), generator=g, device=dev).to(
        torch.bfloat16)
    LAUNCHES.reset()
    attention.attention_qkv_bwd(qkv, gout, 16, 128, 72 ** -0.5,
                                jax_head_dim=72)
    torch.cuda.synchronize()
    launched = LAUNCHES.snapshot()
    check_launches("K10 route at (16, 1024, 6144), d 128 (JAX's 72)",
                   launched, {attention.KERNEL_BWD_TWIN: 1})
    print(f"  K10 route at so400m's (16, 1024, 6144), d 128 (JAX's 72): "
          f"{launched}: JAX's XLA route, no K10 launch [{card}]", flush=True)
    del qkv, gout
    torch.cuda.empty_cache()


# ROADMAP Queue C 1 (phase 2f): K1, K6, K9 and 9b past S = 1024, at
# base-256's width W = Wa = 768 with heads of 64 and with heads of 128
# (so400m's 72 live, scale 72^-0.5), 2 images: S = 1296 (a patch-16 tower
# at 576 px) and a ragged S, not a multiple of the 64-key tile: 1304 for
# K1 and K6 (a multiple of 8: JAX's fits take no other, and K6's wrapper
# sends any other S to the reference route), 1297 for K9 and 9b
LONG_SEQ_K1_K6 = (1296, 1304)
LONG_SEQ_K9_9B = (1296, 1297)


def keys_unmasked(twin, qkv, *args, **kw):
    """A twin with a planted fault: the keys past S let into the softmax as
    a ring of 64-key tiles would hold them unmasked (row S - 1 repeated up
    to the tile); the queries past S dropped."""
    import torch
    b, s, _ = qkv.shape
    sp = -(-s // 64) * 64
    pad = torch.cat([qkv, qkv[:, -1:].expand(b, sp - s, -1)], 1)
    return twin(pad, *args, **kw)[:, :s]


def long_seq_checks(dev, card):
    """Phase 2f: K1 and K6 at LONG_SEQ_K1_K6, K9 and 9b at LONG_SEQ_K9_9B,
    on sharp attention inputs (q, k, v of std 1.5), with and without the
    key bias where the kernel takes one, one launch each, to phase 2b's
    rules: K1 and K6 within atol 5e-2 + rtol 2e-2 and ATTN_REL of the
    attention part, K9 within atol 1e-2 + rtol 2^-7, K9 and 9b with at
    most ATTN_SHARE of the outputs a bf16 step apart; each check shown to
    fail on its planted faults (the scale of the padded head_dim, the bias
    dropped, 9b's aq over 64-row tiles, and at the ragged S the keys past S
    unmasked)."""
    import torch
    from tpudf_torch.core.backend import LAUNCHES
    from tpudf_torch.ops import attention, int8_block
    print("phase 2f: K1, K6, K9 and 9b past S = 1024", flush=True)
    g = torch.Generator(device=dev).manual_seed(31)

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=g, device=dev) * std

    def once(label, counter, fn):
        LAUNCHES.reset()
        out = fn()
        torch.cuda.synchronize()
        check_launches(label, LAUNCHES.snapshot(), {counter: 1})
        return out

    w, b = 768, 2
    for hd, scale in ((64, None), (128, 72 ** -0.5)):
        heads = w // hd
        p = w8a8_layer(randn, dev, w, heads, hd, 4 * w)
        bad_sd, bad_name = wrong_scale(hd, scale)
        for s in sorted({*LONG_SEQ_K1_K6, *LONG_SEQ_K9_9B}):
            qkv = sharp_qkv(randn, b, s, heads, hd, p["live"])
            x = randn(b, s, w).to(torch.bfloat16)
            lb = torch.log(torch.randint(1, 9, (b, s), generator=g,
                                         device=dev).float())
            tag = f"{(b, s, 3 * w)} d={hd}"
            if s in LONG_SEQ_K1_K6:
                args = (x, p["ln1"], p["qkv_wq"], p["qkv_b"], p["out_wq"],
                        p["out_b"], p["a_qkv"], p["a_out"], heads, hd, 1e-6)
                live = None if p["live"] == hd else p["live"]
                for bias in (None, lb):
                    k1 = lambda sc, bi: int8_block.attn_sublayer_int8(
                        *args, sc, logit_bias=bi, live=live)
                    got = once(f"K1 {tag}", int8_block.KERNEL,
                               lambda: k1(scale, bias))
                    ref = int8_block.attn_sublayer_reference(
                        *args, scale, logit_bias=bias)
                    faults = {bad_name: k1(bad_sd, bias)}
                    if bias is not None:
                        faults["bias dropped"] = k1(scale, None)
                    label = f"K1 {tag} bias={bias is not None}"
                    check_close(label, got, ref, atol=5e-2, rtol=2e-2)
                    held_check(f"{label} |Δ|/|attention part|", rel_part(x),
                               ATTN_REL, got, ref, faults, card)
                args = (qkv, x, p["out_wq"], p["out_b"], p["a_out"], heads,
                        hd)
                got = once(f"K6 {tag}", int8_block.KERNEL_ATTN_OUT,
                           lambda: int8_block.attn_out_int8(*args, scale))
                ref = int8_block.attn_out_reference(*args, scale)
                check_close(f"K6 {tag}", got, ref, atol=5e-2, rtol=2e-2)
                held_check(f"K6 {tag} |Δ|/|attention part|", rel_part(x),
                           ATTN_REL, got, ref,
                           {bad_name: int8_block.attn_out_int8(*args,
                                                               bad_sd)},
                           card)
            if s not in LONG_SEQ_K9_9B:
                continue
            for bias in (None, lb):
                k9 = lambda sc, bi: attention.attention_qkv(
                    qkv, heads, hd, sc, logit_bias=bi)
                got = once(f"K9 {tag}", attention.KERNEL,
                           lambda: k9(scale, bias))
                ref = attention.attention_qkv_reference(
                    qkv, heads, hd, scale, logit_bias=bias)
                faults = {bad_name: k9(bad_sd, bias)}
                if bias is not None:
                    faults["bias dropped"] = k9(scale, None)
                elif s % 64:
                    faults["keys unmasked"] = keys_unmasked(
                        attention.attention_qkv_reference, qkv, heads, hd,
                        scale)
                label = f"K9 {tag} bias={bias is not None}"
                check_close(label, got, ref, atol=1e-2, rtol=2 ** -7)
                held_check(f"{label}, share > 1 bf16 step", share_apart,
                           ATTN_SHARE, got, ref, faults, card)
            got = once(f"9b {tag}", attention.KERNEL_INT8,
                       lambda: attention.attention_qkv_int8(qkv, heads, hd,
                                                            scale))
            ref = attention.attention_qkv_int8_reference(qkv, heads, hd,
                                                         scale)
            faults = {
                "aq over 64-row tiles": attention.attention_qkv_int8_reference(
                    qkv, heads, hd, scale, q_block=64),
                bad_name: attention.attention_qkv_int8(qkv, heads, hd,
                                                       bad_sd)}
            if s % 64:
                faults["keys unmasked"] = keys_unmasked(
                    attention.attention_qkv_int8_reference, qkv, heads, hd,
                    scale)
            held_check(f"9b {tag}, share > 1 bf16 step", share_apart,
                       ATTN_SHARE, got, ref, faults, card)
            del qkv, x, lb, got, ref, faults
            torch.cuda.empty_cache()


# the bf16 GEMM of K13, K14 and kernel 15 (phase 2g): (M, K, N) of its
# checks: a ragged M with K % 64 == 32 and N % 256 == 128, the same M with
# a half tile after two whole ones, the out-projection's square K = N
# (there the weight read K-major is a planted fault) and the QKV product
# of the float engine's full analysis of 8 images; at most GEMM_SHARE of
# the outputs more than a bf16 step from the twin
GEMM_SHAPES = [(300, 800, 384), (300, 768, 640), (8192, 768, 768),
               (108544, 768, 2304)]
GEMM_SHARE = 1e-2
# K13's and K14's products at that analysis (M = 108,544): (label, K, N,
# mode), the GEMM launch alone against F.linear, and the factor the
# design aims at (within 1.2x F.linear at K13's shapes)
GEMM_PATHS = [("K13 QKV", 768, 2304, 0),
              ("K13 out-proj + residual", 768, 768, 2),
              ("K13/K14 fc1 + GELU", 768, 3072, 1),
              ("K14 fc2 + residual", 3072, 768, 2)]
GEMM_TARGET = 1.2


def gemm_checks(dev, card):
    """Phase 2g: the GEMM launch (`linear.bf16_gemm_cuda`) against its twin
    (`linear_fused_reference`) at GEMM_SHAPES in MODE 0 with and without a
    bias, MODE 1 and MODE 2: within atol 1e-2 + rtol 2^-7 and at most
    GEMM_SHARE of the outputs a bf16 step apart, each check shown to fail
    on planted faults (a 64-deep K step skipped: the kernel on A with those
    columns zeroed; the bias dropped; GELU dropped; the residual dropped;
    the weight read K-major: the kernel on its transpose)."""
    import torch
    from tpudf_torch.ops import linear
    print("phase 2g: the bf16 GEMM of K13, K14 and 15 vs its twin",
          flush=True)
    g = torch.Generator(device=dev).manual_seed(41)
    bf = torch.bfloat16

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=g, device=dev) * std

    for m, k, n in GEMM_SHAPES:
        a = randn(m, k).to(bf)
        w = randn(k, n, std=k ** -0.5).to(bf)
        bias = randn(n, std=0.1)
        res = randn(m, n).to(bf)
        a_skip = a.clone()
        k0 = (k // 128) * 64               # a 64-deep K step mid-way
        a_skip[:, k0:k0 + 64] = 0.0

        def run(mode, a_=a, w_=w, b_=bias):
            return linear.bf16_gemm_cuda(a_, w_, b_, mode,
                                         res if mode == 2 else None)

        def twin(mode, b_=bias):
            return linear.linear_fused_reference(
                a, w, b_, residual=res if mode == 2 else None,
                activation="gelu" if mode == 1 else None)

        cases = [("MODE 0", run(0), twin(0),
                  {"bias dropped": run(0, b_=None),
                   "K step skipped": run(0, a_=a_skip)}),
                 ("MODE 0 null bias", run(0, b_=None), twin(0, None),
                  {"K step skipped": run(0, a_=a_skip, b_=None)}),
                 ("MODE 1", run(1), twin(1), {"GELU dropped": run(0)}),
                 ("MODE 2", run(2), twin(2), {"residual dropped": run(0)})]
        if k == n:
            cases[0][3]["W read K-major"] = run(0, w_=w.t().contiguous())
        torch.cuda.synchronize()
        for label, got, ref, faults in cases:
            label = f"GEMM {(m, k, n)} {label}"
            check_close(label, got, ref, atol=1e-2, rtol=2 ** -7)
            held_check(f"{label}, share > 1 bf16 step", share_apart,
                       GEMM_SHARE, got, ref, faults, card)
        del a, w, res, a_skip, cases
        torch.cuda.empty_cache()


def gemm_path_timings(dev, card):
    """The GEMM launch alone at GEMM_PATHS beside F.linear (device times by
    the profiler, CUDA-event times of the call; where the profiler records
    no device time, the factor is taken from the event times and says
    so), the factor against GEMM_TARGET, F.linear with the epilogue's
    GELU or residual add as a second call, the bound, and the tensor maps
    a launch encodes on the host. Run in phase 2, beside the checks: late
    in a run the profiler has returned no device events here."""
    import torch
    import torch.nn.functional as F
    from tpudf_torch.ops import linear
    g = torch.Generator(device=dev).manual_seed(43)
    bf = torch.bfloat16

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=g, device=dev) * std

    m = 8 * VIEWS * 256
    print(f"  GEMM launch alone at M = {m}: tensor maps encoded on the host "
          f"a launch: 3 (A, W, out), 4 in MODE 2 (+ the residual)",
          flush=True)
    for label, k, n, mode in GEMM_PATHS:
        a = randn(m, k).to(bf)
        w = randn(k, n, std=k ** -0.5).to(bf)
        bias = randn(n, std=0.1)
        res = randn(m, n).to(bf) if mode == 2 else None
        wt, b16 = w.t(), bias.to(bf)
        kern = lambda: linear.bf16_gemm_cuda(a, w, bias, mode, res)
        lib = lambda: F.linear(a, wt, b16)
        # the same function in two PyTorch calls, where the epilogue has
        # an operation of its own (timed only)
        two = {1: lambda: F.gelu(F.linear(a, wt, b16), approximate="tanh"),
               2: lambda: F.linear(a, wt, b16) + res}.get(mode)
        two_ms = ""
        if two is not None:
            what = "GELU" if mode == 1 else "residual"
            two_ms = (f"; F.linear + {what} (two calls) "
                      f"{cuda_ms(two, 10):.4f} ms")
        ms, lib_ms = cuda_ms(kern, 10), cuda_ms(lib, 10)
        dev_ms, lib_dev = device_ms(kern), device_ms(lib)
        by = "device"
        if not dev_ms or not lib_dev:       # no device events recorded
            dev_ms, lib_dev, by = ms, lib_ms, "events"
        b_ms, b_by = bound({"bf16": 2 * m * k * n},
                           nbytes(a, w, bias, res) + m * n * 2)
        factor = dev_ms / lib_dev
        verdict = "within" if factor <= GEMM_TARGET else "past"
        print(f"  {label} ({m}, {k}, {n}) MODE {mode}: kernel {ms:.4f} ms "
              f"({by} {dev_ms:.4f}), F.linear {lib_ms:.4f} ms ({by} "
              f"{lib_dev:.4f}): {factor:.2f}x {by} ({verdict} "
              f"{GEMM_TARGET}x){two_ms}; bound {b_ms:.4f} ms ({b_by}), "
              f"{2 * m * k * n / dev_ms / 1e9:.1f} TFLOP/s [{card}]",
              flush=True)
        del a, w, res, wt
        torch.cuda.empty_cache()


# the probes' kernels (phase 2e): the tolerances of
# tests/test_torch_port_probes.py, (bf16 steps, atol) against the twin;
# on the card the bf16 product sums 768 products (the CPU test 128), so
# its atol is 2e-5 (f32 sums in another order on the tensor cores, at an
# output that cancels to near 0). Kernel 17: 9b's card rule (at most
# ATTN_SHARE of the outputs more than a bf16 step apart, all within atol
# 1e-2 + rtol 2^-7). k_pure: bit-equal.
PROBE_TOL = {"15-bf16": (1, 2e-5), "15-int8": (1, 0.0),
             "16-full": (1, 1e-6), "16-nogelu": (1, 0.0),
             "16-bf16_epi": (2, 0.0), "16-noquant": (1, 0.0)}


def probe_agrees(key, got, ref):
    """(within the key's tolerance, share more than one bf16 step apart,
    max |Δ|)."""
    import torch
    if key == "16-pure":
        same = bool(torch.equal(got, ref))
        return same, 0.0 if same else 1.0, max_abs(got, ref)
    share = share_apart(got, ref)
    if key == "17":
        err = (got.float() - ref.float()).abs()
        ok = bool((err <= 1e-2 + 2 ** -7 * ref.float().abs()).all())
        return ok and share <= ATTN_SHARE, share, max_abs(got, ref)
    steps, atol = PROBE_TOL[key]
    a, b = got.float(), ref.float()
    lim = steps * bf16_step(torch.maximum(a.abs(), b.abs())) + atol
    ok = bool(((a - b).abs() <= lim).all() and torch.isfinite(a).all())
    return ok, share, max_abs(got, ref)


def probe_stale_panel(ref, m, n, sms):
    """The quantising GEMM's output had no block rebuilt its panel after
    its first unit: each later unit's columns computed from the rows of
    the block's first unit (`common.quant_units`)."""
    from tpudf_torch.probes import common
    out = ref.clone()
    t, w = 128, common.QUANT_TILE
    for block in common.quant_units(m, n, sms):
        r0 = block[0][0]
        for rt, run in block[1:]:
            rows = min(t, m - rt * t, m - r0 * t)
            c0, c1 = min(run) * w, min(n, (max(run) + 1) * w)
            out[rt * t:rt * t + rows, c0:c1] = \
                ref[r0 * t:r0 * t + rows, c0:c1]
    return out


def probe_unstored_run(got, m, n, sms):
    """The quantising GEMM's output with one unit's run of columns (block
    0's last unit) left as a buffer pre-filled with 7 had it."""
    from tpudf_torch.probes import common
    rt, run = common.quant_units(m, n, sms)[0][-1]
    w = common.QUANT_TILE
    out = got.clone()
    out[rt * 128:(rt + 1) * 128, min(run) * w:(max(run) + 1) * w] = 7.0
    return out


def probe_route_timings(rec, key, mode, x, wt, s, b, act, card):
    """The quantising GEMM in `mode` on x (M, K) and wt (N, K) by device
    time: the one launch where K takes it, the split form (the codes' row
    pass, then the int8 GEMM in the same mode) and its two launches alone,
    beside the bound; the split form bit-equal to the one launch where
    both apply. Into `key`'s row as "routes"."""
    import torch
    from tpudf_torch.ops import _build
    from tpudf_torch.probes import common
    m, k = x.shape
    n = wt.shape[0]
    codes = torch.empty((m, k), dtype=torch.int8, device=x.device)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    mode_n = common.QUANT_MODES[mode]
    bias = None if b is None else b.float()

    def rows():
        _build.call("tpudf_quant_rows_i8", x, act, codes, m, k)

    def gemm():
        _build.call("tpudf_i8_gemm", codes, wt, s, bias, act, None, out, None,
                    None, m, n, k, mode_n)

    def split():
        return common.quant_gemm_split(mode, x, wt, s, b, act)

    case = {"shape": (m, k, n), "split_device_ms": device_ms(split),
            "rows_device_ms": device_ms(rows),
            "gemm_device_ms": device_ms(gemm)}
    case["bound_ms"], case["bound_by"] = bound(
        {"int8": 2 * m * k * n}, nbytes(x, wt, s, b) + m * n * 2)
    line = ""
    if common.quant_route(k) == "one":
        one = common.quant_gemm_cuda(mode, x, wt, s, b, act)
        same = bool(torch.equal(one, split()))
        case["one_device_ms"] = device_ms(lambda: common.quant_gemm_cuda(
            mode, x, wt, s, b, act))
        line = (f"one launch {case['one_device_ms']:.4f} ms, split form "
                f"bit-equal {same}; ")
        if not same:
            raise AssertionError(f"{key} {mode} {(m, k, n)}: the split form "
                                 f"differs from the one launch")
        del one
    print(f"  {key} {(m, k, n)} device: {line}split form "
          f"{case['split_device_ms']:.4f} ms (row pass "
          f"{case['rows_device_ms']:.4f} + GEMM on the codes "
          f"{case['gemm_device_ms']:.4f}); bound {case['bound_ms']:.4f} ms "
          f"({case['bound_by']}) [{card}]", flush=True)
    rec.rows[key].setdefault("routes", []).append(case)
    del codes, out
    torch.cuda.empty_cache()


# kernel 17's planted faults (`k17_fault`); the first two bite only where
# every real score of a row is negative
K17_FAULTS = ("max over the keys past S", "keys past S in l",
              "tile 1 skipped in sweep 2", "o without ap")


def k17_negative(g, b, s, heads, d):
    """qkv (b, s, 3 heads d) bf16 whose k rows are one shared vector plus
    noise of std 0.3 and q = -k: every real score of a row is negative
    (about -|k|^2), so zero scores past S would be every row's max."""
    import torch
    x = torch.randn((b, s, 3, heads, d), generator=g, device=g.device)
    k = torch.randn((1, 1, heads, d), generator=g, device=g.device) + \
        0.3 * x[:, :, 1]
    x[:, :, 1], x[:, :, 0] = k, -k
    return x.reshape(b, s, 3 * heads * d).to(torch.bfloat16)


def k17_fault(qkv, heads, scale, fault):
    """Kernel 17's output had its main pass the planted `fault`, computed
    in the kernel's order on the twin's codes (f32 sums of q8 . k8 exact:
    at most 127^2 128 < 2^24; p8 . v8 in f64): K17_FAULTS[0] the first
    sweep's integer max over the zero scores of the keys past S on the last
    64-key tile, [1] those keys' e added to l, [2] keys 64-127 left out of
    l and p8 . v8, [3] o = int32(p8 . v8) cv without ap."""
    import torch
    from tpudf_torch.probes import common
    from tpudf_torch.probes import micro_attn_static as p17
    b, s, _ = qkv.shape
    d = p17.HEAD_DIM
    c = p17.static_scales(scale)
    keys = -(-s // 64) * 64
    t = qkv.reshape(b, s, 3, heads, d).permute(2, 0, 3, 1, 4)
    q8 = common.quant_codes(t[0], c["inv_q"])
    k8, v8 = (torch.nn.functional.pad(common.quant_codes(t[i], c[n]),
                                      (0, 0, 0, keys - s))
              for i, n in ((1, "inv_k"), (2, "inv_v")))
    acc = torch.matmul(q8, k8.transpose(-1, -2))
    live = torch.arange(keys, device=qkv.device) < s
    if fault == K17_FAULTS[0]:
        live = torch.ones_like(live)
    fac2 = common.f32(c["fac"] * common.f32(1.4426950408889634))  # kLog2e
    m = torch.where(live, acc, -torch.inf).amax(-1, keepdim=True) * fac2
    e = torch.exp2(acc * fac2 - m)
    if fault != K17_FAULTS[1]:
        e[..., s:] = 0.0
    if fault == K17_FAULTS[2]:
        e[..., 64:128] = 0.0
    p8 = torch.round(e * 127.0)
    pv = torch.matmul(p8.double(), v8.double()).float()
    ap = 1.0 / e.sum(-1, keepdim=True) + 1e-20
    o = pv * (c["cv"] if fault == K17_FAULTS[3] else ap * c["cv"])
    return o.transpose(1, 2).reshape(b, s, heads * d).to(torch.bfloat16)


def k17_timings(rec, qkv, heads, scale, card):
    """Kernel 17's two launches alone by device time at qkv's shape,
    beside its bound, 9b's main pass on the same codes (q8 from the plain
    codes, an amax table of 3.0: 9b's two-exp sweeps on the static codes),
    the whole call and SDPA in bf16; into the "17" row as "device"."""
    import torch
    from tpudf_torch.ops import attention
    from tpudf_torch.probes import micro_attn_static as p17
    b, s, w3 = qkv.shape
    d = p17.HEAD_DIM
    codes = p17.static_prepass(qkv, heads)
    q8 = p17.static_codes_reference(qkv, heads)[0]
    qb = min(attention.INT8_Q_BLOCK, s)
    amax = torch.full((b, heads, -(-s // qb) + 2), 3.0, device=qkv.device)
    row = {"shape": (b, s, w3),
           "prepass_ms": device_ms(lambda: p17.static_prepass(qkv, heads)),
           "main_ms": device_ms(lambda: p17.static_main(qkv, codes, heads,
                                                        scale)),
           "call_ms": device_ms(lambda: p17.attention_qkv_int8_static(
               qkv, heads, d, scale)),
           "9b_main_same_codes_ms": device_ms(lambda: attention.i8dyn_main(
               (amax, q8, *codes), b, s, heads, d, qb, scale)),
           "sdpa_bf16_ms": device_ms(p17.sdpa_bf16(qkv, heads, d, scale)),
           "scratch_bytes": sum(nbytes(x) for x in codes)}
    row["bound_ms"], row["bound_by"] = bound(
        {"int8": 4 * b * heads * s * s * d}, nbytes(qkv) + b * s * w3 // 3 * 2)
    total = row["prepass_ms"] + row["main_ms"]
    print(f"  17 {(b, s, w3)} device: pre-pass {row['prepass_ms']:.4f} ms + "
          f"main pass {row['main_ms']:.4f} ms = {total:.4f} ms (the call "
          f"{row['call_ms']:.4f}); bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}, {row['bound_ms'] / total:.3f} of it); 9b's "
          f"main pass on the same codes {row['9b_main_same_codes_ms']:.4f} "
          f"ms; SDPA bf16 {row['sdpa_bf16_ms']:.4f} ms; scratch "
          f"{row['scratch_bytes'] / 1e6:.1f} MB [{card}]", flush=True)
    rec.rows["17"]["device"] = row
    del codes, q8, amax
    torch.cuda.empty_cache()


def probe_checks(rec, dev, card):
    """Phase 2e: kernels 15, 16 and 17 (`tpudf_torch/probes`) at their JAX
    probes' full shapes against their twins on the probes' seeded inputs:
    one launch a call (17: its pre-pass and its main pass, also at S =
    1000 on the probe's inputs and on negative scores, `k17_negative`, its
    pre-pass's codes bit-equal to the twin's), the tolerances of
    PROBE_TOL, each check shown to fail on planted faults (15: the twin's
    last 32-deep K slice dropped, x quantised at amax 3.9; 16: GELU
    dropped, the bias dropped, the 4/127 factor in k_bf16_epi's chain, act
    3.9, torch._int_mm on x with its last 64 columns zeroed; 17: aq = 3.1,
    a 64-key tile skipped in the second sweep, o without ap, and on the
    negative scores the keys past S in the max or in l (`k17_fault`); the
    quantising GEMMs on their quant panel also: a 128-deep panel slice
    left zero, the panel not rebuilt after a block's first unit (where
    blocks walk several row tiles), one run of columns unstored, the bias
    or GELU (15: the scale) dropped in half a 256-wide tile), k_pure
    bit-equal to torch._int_mm; kernel, twin and library timed (17's two
    launches also alone, `k17_timings`). The
    quantising GEMMs' split form (`common.quant_gemm_split`: the codes'
    row pass, then the int8 GEMM) bit-equal to the
    one launch at the probes' shapes, and the wrappers' own route at K =
    1600 (split, its own counter) held to the twin with the codes' last 64
    columns zeroed as a fault; each one launch, the split form and its two
    parts timed by device time (`probe_route_timings`). Then each probe's
    main(), counts set to 0 just before it: its launches of the probe's
    kernels must equal the calls it made, and are returned as the kernels
    line's counts (17's pre-pass's as its row's "prepass_launches")."""
    import torch
    from tpudf_torch.core.backend import LAUNCHES
    from tpudf_torch.probes import common
    from tpudf_torch.probes import micro_attn_static as p17
    from tpudf_torch.probes import micro_epilogue as p16
    from tpudf_torch.probes import micro_pallas_int8 as p15
    print("phase 2e: kernels 15-17 (the probes) vs twins", flush=True)
    act = common.act_scale(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def held(key, label, counter, call, twin, faults, work, **timing):
        """faults: {name: fn(got, ref) -> a faulty output}; counter: the
        counter of the call's one launch, or {counter: launches}."""
        LAUNCHES.reset()
        got = call()
        torch.cuda.synchronize()
        check_launches(label, LAUNCHES.snapshot(),
                       counter if isinstance(counter, dict) else {counter: 1})
        ref = twin()
        ok, share, err = probe_agrees(key, got, ref)
        caught = {}
        for name, fault in faults.items():
            caught[name] = not probe_agrees(key, got, fault(got, ref))[0]
            torch.cuda.empty_cache()
        print(f"  {key} {label}: max|Δ| {err:.3e}, share > 1 bf16 step "
              f"{share:.3e}, within tolerance {ok}; planted faults: "
              + ", ".join(f"{k} {'caught' if c else 'MISSED'}"
                          for k, c in caught.items()) + f" [{card}]",
              flush=True)
        if not ok:
            raise AssertionError(f"{key} {label} vs twin: max|Δ| {err:.3e},"
                                 f" share {share:.3e}")
        if not all(caught.values()):
            raise AssertionError(f"{key} {label}: the check misses "
                                 f"{[k for k, c in caught.items() if not c]}")
        if work is not None:
            rec.add(key, label, tuple(got.shape), err, call, twin, work,
                    **timing)
        del got, ref
        torch.cuda.empty_cache()

    def panel_faults(twin_on, x, m, n):
        """The quant panel's planted faults: twin_on(x) is the twin on
        another x."""
        hole = x.clone()
        hole[:, 128:256] = 0
        faults = {"panel slice 128-255 left zero": lambda *_: twin_on(hole),
                  "one run unstored": lambda got, _: probe_unstored_run(
                      got, m, n, sms)}
        if any(len(blk) > 1 for blk in common.quant_units(m, n, sms)):
            faults["panel not rebuilt"] = lambda _, ref: probe_stale_panel(
                ref, m, n, sms)
        return faults

    def half_tile(ref, other):
        """ref with columns 128-255 (half the first 256-wide tile) from
        other."""
        out = ref.clone()
        out[:, 128:256] = other[:, 128:256]
        return out

    # ---- 15 at (16384, 768, 3072)
    t = p15.inputs(dev)
    x, w_bf, wt, s = t["x"], t["w_bf"], t["wt"], t["s"]
    m, k, n = p15.M, p15.K, p15.N
    out_bytes = m * n * 2                    # the bf16 output
    held("15-bf16", "bf16_matmul", p15.KERNEL_BF16,
         lambda: p15.bf16_matmul(x, w_bf),
         lambda: p15.bf16_matmul_reference(x, w_bf),
         {"last K slice dropped": lambda *_: p15.bf16_matmul_reference(
             x[:, :-32], w_bf[:-32])},
         ({"bf16": 2 * m * k * n}, nbytes(x, w_bf) + out_bytes),
         library={"torch.matmul bf16": lambda: torch.matmul(x, w_bf)},
         iters=20, twin_iters=5)

    def q_at(amax):
        return ((common.int_dot(common.quant_codes(x, 127.0 / amax), wt)
                 .float() * common.C_ACT) * s).to(torch.bfloat16)

    faults = {"amax 3.9": lambda *_: q_at(3.9),
              "scale dropped in half a tile": lambda _, ref: half_tile(
                  ref, p15.int8_matmul_staticq_reference(
                      x, wt, torch.ones_like(s)))}
    faults.update(panel_faults(
        lambda xx: p15.int8_matmul_staticq_reference(xx, wt, s), x, m, n))
    held("15-int8", "int8_matmul_staticq", p15.KERNEL_INT8,
         lambda: p15.int8_matmul_staticq(x, wt, s, act=act),
         lambda: p15.int8_matmul_staticq_reference(x, wt, s), faults,
         ({"int8": 2 * m * k * n}, nbytes(x, wt, s) + out_bytes),
         library=p15.library_parts(x, wt, s), iters=20, twin_iters=5,
         device_time=True)
    probe_route_timings(rec, "15-int8", "staticq", x, wt, s, None, act,
                        card)
    del t, x, w_bf, wt, s
    torch.cuda.empty_cache()

    # ---- 16 at (65536, 768, 3072)
    t = p16.inputs(dev)
    wt, s, b = t["wt"], t["s"], t["b"]
    m, k, n = p16.M, p16.K, p16.N
    xi = t["x_i8"]
    bf = torch.bfloat16

    def twin_of(v, x=None, **kw):
        return lambda *_: p16.fc1_matmul_reference(
            v, p16.x_of(v, t) if x is None else x, wt, s, b, **kw)

    xi_cut = xi.clone()
    xi_cut[:, -64:] = 0
    no_bias = torch.zeros_like(b)
    faults = {
        "full": {"GELU dropped": twin_of("nogelu"),
                 "GELU dropped in half a tile": lambda _, ref: half_tile(
                     ref, twin_of("nogelu")())},
        "nogelu": {"bias dropped": lambda *_: p16.fc1_matmul_reference(
            "nogelu", t["x_bf"], wt, s, no_bias),
            "bias dropped in half a tile": lambda _, ref: half_tile(
                ref, p16.fc1_matmul_reference("nogelu", t["x_bf"], wt, s,
                                              no_bias))},
        "bf16_epi": {"4/127 factor added": lambda *_: p16.epilogue(
            "bf16_epi", common.int_dot(common.quant_codes(
                t["x_bf"], common.INV_ACT), wt), (s * common.C_ACT), b),
            "bias dropped in half a tile": lambda _, ref: half_tile(
                ref, p16.fc1_matmul_reference("bf16_epi", t["x_bf"], wt, s,
                                              no_bias))},
        "noquant": {"act 3.9": lambda *_: (common.int_dot(xi, wt).float() * (
            common.f32(3.9 / 127.0) * s) + b).to(bf)},
        "pure": {"x's last 64 columns zeroed": lambda *_: torch._int_mm(
            xi_cut, wt.t())}}
    for v in p16.QUANTISED:
        faults[v].update(panel_faults(
            lambda xx, v=v: p16.fc1_matmul_reference(v, xx, wt, s, b),
            t["x_bf"], m, n))
    for v in p16.VARIANTS:
        x = p16.x_of(v, t)
        ins = (x, wt) if v == "pure" else (x, wt, s, b)
        out_bytes = m * n * (4 if v == "pure" else 2)
        held(f"16-{v}", f"fc1_matmul {v}", p16.KERNELS[v],
             lambda: p16.fc1_matmul(v, x, wt, s, b, act=act), twin_of(v),
             faults[v], ({"int8": p16.OPS}, nbytes(*ins) + out_bytes),
             library=p16.library(v, t), iters=10, twin_iters=3,
             device_time=v in p16.QUANTISED or v == "noquant")
        if v in p16.QUANTISED:
            probe_route_timings(rec, f"16-{v}", v, x, wt, s, b, act, card)
        if v == "pure":
            got = p16.fc1_matmul(v, x, wt, s, b)
            same = bool(torch.equal(got, torch._int_mm(x, wt.t())))
            print(f"  16-pure bit-equal to torch._int_mm: {same} [{card}]",
                  flush=True)
            if not same:
                raise AssertionError("16-pure differs from torch._int_mm")
            del got
        torch.cuda.empty_cache()
    del t, wt, s, b, xi, xi_cut, faults
    torch.cuda.empty_cache()

    # ---- the split route where the panel does not fit: K = 1600
    g = torch.Generator(device=dev).manual_seed(16)
    m, k, n = 16384, common.MAX_K, 3072
    x = torch.randn((m, k), generator=g, device=dev).to(bf)
    wt = torch.randint(-127, 128, (n, k), generator=g, device=dev,
                       dtype=torch.int8)
    s = torch.rand((n,), generator=g, device=dev) * 0.01 + 0.01
    b = torch.rand((n,), generator=g, device=dev)
    cut = x.clone()
    cut[:, -64:] = 0
    held("15-int8", f"int8_matmul_staticq K={k} (split)",
         p15.KERNEL_INT8_SPLIT,
         lambda: p15.int8_matmul_staticq(x, wt, s, act=act),
         lambda: p15.int8_matmul_staticq_reference(x, wt, s),
         {"codes' last 64 columns zeroed": lambda *_:
          p15.int8_matmul_staticq_reference(cut, wt, s)}, None)
    for v in p16.QUANTISED:
        held(f"16-{v}", f"fc1_matmul {v} K={k} (split)",
             p16.KERNELS_SPLIT[v],
             lambda: p16.fc1_matmul(v, x, wt, s, b, act=act),
             lambda: p16.fc1_matmul_reference(v, x, wt, s, b),
             {"codes' last 64 columns zeroed": lambda *_:
              p16.fc1_matmul_reference(v, cut, wt, s, b)}, None)
    probe_route_timings(rec, "16-nogelu", "nogelu", x, wt, s, b, act, card)
    del x, wt, s, b, cut
    torch.cuda.empty_cache()

    # ---- 17 at so400m-pad (8, 1024, 6144), 16 heads of 128, then at S =
    # 1000 (ragged: keys past S on the last tile) on the probe's inputs and
    # on negative scores (every real score of a row below 0)
    name, b, s, w, d = p17.GEOMETRIES[0]
    heads, scale = w // d, d ** -0.5
    g = torch.Generator(device=dev).manual_seed(0)
    qkv = torch.randn((b, s, 3 * w), generator=g, device=dev).to(bf)
    both = {p17.KERNEL_PREPASS: 1, p17.KERNEL: 1}
    cases = [("", qkv), (" S=1000", qkv[:, :1000].contiguous()),
             (" S=1000 negative", k17_negative(g, b, 1000, heads, d))]
    for tag, x in cases:
        faults = {f: (lambda *_, x=x, f=f: k17_fault(x, heads, scale, f))
                  for f in (K17_FAULTS if "negative" in tag
                            else K17_FAULTS[2:])}
        faults["aq 3.1"] = lambda *_, x=x: \
            p17.attention_qkv_int8_static_reference(x, heads, d, scale,
                                                    aq=3.1)
        codes = p17.static_prepass(x, heads)
        same = [bool(torch.equal(u, v)) for u, v in zip(
            codes, p17.static_codes_reference(x, heads)[1:])]
        print(f"  17{tag}: pre-pass codes bit-equal to the twin's {same} "
              f"[{card}]", flush=True)
        if not all(same):
            raise AssertionError(f"17{tag}: the pre-pass's codes")
        held("17", f"attention_qkv_int8_static{tag}", both,
             lambda x=x: p17.attention_qkv_int8_static(x, heads, d, scale),
             lambda x=x: p17.attention_qkv_int8_static_reference(
                 x, heads, d, scale), faults,
             None if tag else ({"int8": 4 * b * heads * s * s * d},
                               nbytes(x) + b * s * w * 2),
             nearest={"SDPA bf16 (nearest)": p17.sdpa_bf16(x, heads, d,
                                                           scale)},
             iters=20, twin_iters=3)
        del codes
    k17_timings(rec, qkv, heads, scale, card)
    del qkv, cases
    torch.cuda.empty_cache()

    # ---- each probe's main(): its lines, and the launches of its run
    launches = {}
    keys = {p15.KERNEL_BF16: "15-bf16", p15.KERNEL_INT8: "15-int8",
            p17.KERNEL: "17", p17.KERNEL_PREPASS: "17-prepass",
            **{c: f"16-{v}" for v, c in p16.KERNELS.items()}}
    for probe in (p17, p15, p16):
        LAUNCHES.reset()
        made = probe.main()["launches"]
        torch.cuda.synchronize()
        seen = LAUNCHES.snapshot()
        check_launches(f"{probe.__name__}.main()",
                       {c: seen.get(c, 0) for c in made}, made)
        launches.update({keys[c]: n for c, n in made.items()})
        torch.cuda.empty_cache()
    rec.rows["17"]["prepass_launches"] = launches.pop("17-prepass")
    return launches


def mtl_batches_at(dev, size, b, steps, seed):
    """Seeded MTL batches of b images of size x size: pixels in [-1, 1],
    3-class labels, one square mask each, every other one flagged (so that
    each batch's seg loss reaches the decoder)."""
    import torch
    bg = torch.Generator(device=dev).manual_seed(seed)
    out, side = [], size // 4
    for _ in range(steps):
        masks = torch.zeros((b, size, size), device=dev)
        for i in range(b):
            y0, x0 = torch.randint(0, size - side, (2,), generator=bg,
                                   device=dev)
            masks[i, y0:y0 + side, x0:x0 + side] = 1.0
        out.append({
            "pixels": torch.rand((b, size, size, 3), generator=bg,
                                 device=dev) * 2 - 1,
            "cls": torch.randint(0, 3, (b,), generator=bg, device=dev),
            "mask": masks,
            "has_mask": (torch.arange(b, device=dev) % 2 == 0).float()})
    return out


def real_fake_folder(root, n, size, seed):
    """A TRAIN/VAL x REAL|FAKE folder of n seeded PNGs per class and split
    (FAKE brighter), the binary CLI's layout."""
    import numpy as np
    from PIL import Image
    rng = np.random.default_rng(seed)
    for split in ("train", "val"):
        for cls, bias in (("REAL", 0.0), ("FAKE", 0.5)):
            d = os.path.join(root, split, cls)
            os.makedirs(d, exist_ok=True)
            for i in range(n):
                arr = np.clip(rng.random((size, size, 3)) * 0.5 + bias, 0, 1)
                Image.fromarray((arr * 255).astype(np.uint8)).save(
                    os.path.join(d, f"{i}.png"))


def binary_run(make, ks, label, batches, dev, card, ema_decay=None):
    """Steps of a BinaryTrainer (`make(ks)`) on the seeded batches, each
    with the launch counts set to 0 just before it and a generator seeded
    by its index (the same mixup and dropout draws for kernels and
    twins): (losses, step-1 gradients by leaf, launches per step, the
    trainer and state). With ema_decay: the EMA held to its formula from
    the parameters after each step (relative 1e-6)."""
    import numpy as np
    import torch
    from tpudf_torch.core.backend import LAUNCHES
    from tpudf_torch.train.steps import tensor_leaves
    t0 = time.perf_counter()
    tr = make(ks)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    state = tr.state
    ema = ([p.detach().clone() for p in tensor_leaves(state.params)]
           if ema_decay else None)
    losses, grads0, per_step = [], None, []
    for i, batch in enumerate(batches):
        LAUNCHES.reset()
        state, m = tr.step(state, tr.backbone, batch,
                           torch.Generator(device=dev).manual_seed(100 + i))
        torch.cuda.synchronize()
        per_step.append(LAUNCHES.snapshot())
        losses.append(float(m["loss"]))
        if i == 0:
            grads0 = (trainable_slices(state.params, "grad", 0)
                      if "backbone" in state.params else
                      {f"head leaf {j}": p.grad.float().clone()
                       for j, p in enumerate(tensor_leaves(state.params))})
        if ema is not None:
            for e, p in zip(ema, tensor_leaves(state.params)):
                e.mul_(ema_decay).add_(p.detach(), alpha=1 - ema_decay)
    if not np.isfinite(losses).all():
        raise AssertionError(f"binary {label}: losses {losses}")
    msg = ""
    if ema is not None:
        rel = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                  for a, b in zip(tensor_leaves(state.ema), ema))
        msg = f"; EMA vs its formula max rel |Δ| {rel:.3e}"
        if rel > 1e-6:
            raise AssertionError(f"binary {label}: EMA {rel:.3e}")
    print(f"binary {label}: build {build_s:.2f} s; losses "
          f"{['%.6f' % v for v in losses]}{msg} [{card}]", flush=True)
    return losses, grads0, per_step, (tr, state)


def binary_versus(label, run, ref, limit, card):
    """|Δloss| per step within `limit`, the step-1 gradient cosine >= 0.99
    over all trainable parameters; returns the worst relative step-1
    gradient error of the tower's slices (`trainable_slices`: each block
    layer's leaf, a third of a fused q|k|v leaf, the key biases left out),
    where the tower trains, else of the head's leaves. The heads' slices
    are printed, not held: the v5 head's SE gate at B = 8 has a gradient
    small next to the rounding of the features it reads (7.3e-2 measured
    on an H100), and the head runs no kernel."""
    import torch
    import torch.nn.functional as F
    dloss = [abs(a - b) for a, b in zip(run[0], ref[0])]
    names = list(ref[1])
    cos = float(F.cosine_similarity(
        torch.cat([run[1][n].flatten() for n in names]),
        torch.cat([ref[1][n].flatten() for n in names]), dim=0))
    rel = {n: float(torch.linalg.vector_norm(run[1][n] - ref[1][n])
                    / torch.linalg.vector_norm(ref[1][n]).clamp_min(1e-30))
           for n in names}
    worst = max(rel, key=rel.get)
    tower = {n: v for n, v in rel.items() if n.startswith("blocks.")}
    worst_t = max(tower, key=tower.get) if tower else None
    print(f"binary {label}: |Δloss| per step {['%.3e' % d for d in dloss]}; "
          f"step-1 gradient cosine {cos:.6f}; worst slice step-1 gradient "
          f"error {rel[worst]:.3e} ({worst})"
          + (f", of the tower's {tower[worst_t]:.3e} ({worst_t})" if tower
             else "") + f" [{card}]", flush=True)
    if max(dloss) > limit or cos < 0.99:
        raise AssertionError(f"binary {label}: runs disagree")
    return tower[worst_t] if tower else rel[worst]


def training_rest(dev, card, tmp):
    """Phase 3t, each path with the launch counts set to 0 just before it
    and read just after:
    (t2) large-384 MTL at its native 384 px (S = 576, no interpolation;
    freeze_below 21, taps (2, 6, 10, -1), embed_dim 256, B = 16), float (a)
    and int8 (b) prefix, LARGE_STEPS steps each against the twins: exact
    launches (K10 3 a step at (16, 576, 3072)), |Δloss|, the step-1
    gradient cosine per group, frozen parameters bit-identical, and on (a)
    phase 3 (d)'s per-slice limits;
    (t3) so400m-512 MTL at 512 px (freeze_below 24: 3 of 27 layers
    trainable, B = 8, float prefix), LARGE_STEPS steps against the twins:
    K14 at the compute copy's hidden of 4352 in every layer, no K10 launch
    and the twin's VJP 3 times a step (JAX's fit fails), |Δloss|, group
    cosine, frozen bit-identical (slices printed);
    (t4) the binary trainer at large-384, 384 px (`build_binary_trainer`):
    the frozen bf16 tower with the v5 head, EMA 0.999 and mixup 0.2 at B =
    64; the W8A8 tower with the deployed ToMe (calibrated on the first
    batch's 16 images); the fast head; LARGE_STEPS steps each against the
    twins (every trainer from a copy of one seed-0 tower): exact launches,
    |Δloss|, the step-1 head-gradient cosine, the EMA equal to its
    formula; the tower trained with the head at B = 8, 2 steps with
    and without remat against the twins: K10 24 times a step, K9 24 and
    48 with remat, the remat gradients within the twin limits of those
    without; the binary CLI for one epoch on a seeded REAL/FAKE folder,
    then --evaluate_only --resume. Returns the trainers phase 4 times."""
    import torch
    import tpudf_torch.entry as entry
    from tpudf_torch.core.precision import tree_map
    from tpudf_torch.entry import (build_binary_trainer, build_mtl_trainer,
                                   mtl_params)
    from tpudf_torch.models.siglip import CONFIGS, init_siglip
    from tpudf_torch.ops import (attention, int8_block, layernorm, linear,
                                 mlp)
    from tpudf_torch.ops.routes import KERNELS, TWINS
    from tpudf_torch.ops.tome import DEPLOYED_TOME_R, deployed_floor

    root = os.path.dirname(os.path.abspath(__file__))
    state = {}
    print("phase 3t: training at the large backbones (large-384 MTL at 384 "
          "px, so400m-512 MTL, the binary trainer)", flush=True)

    # ---- (t2) large-384 MTL at 384 px
    name, layers, freeze = "large-384", 24, 21
    b384 = mtl_batches_at(dev, 384, MTL_BATCH, LARGE_STEPS, 31)
    t2_tree = mtl_params(dev, seed=0, cfg_name=name)

    def make(cfg_key, ks=KERNELS):
        return build_mtl_trainer(
            fresh(t2_tree), cfg_name=name, image_size=384,
            freeze_below=freeze, seg_layers=(2, 6, 10, -1), embed_dim=256,
            int8_frozen=cfg_key == "b", lr=MTL_LR, warmup_steps=1,
            calib_pixels=b384[0]["pixels"], kernels=ks)

    trainable = layers - freeze
    t2_expect = {
        "a": {linear.KERNEL: 2 * layers, attention.KERNEL: layers,
              mlp.KERNEL_BF16: layers, layernorm.KERNEL: 2,
              attention.KERNEL_BWD: trainable},
        "b": {int8_block.KERNEL: freeze, mlp.KERNEL: freeze,
              linear.KERNEL: 2 * trainable, attention.KERNEL: trainable,
              mlp.KERNEL_BF16: trainable, layernorm.KERNEL: 2,
              attention.KERNEL_BWD: trainable}}
    for cfg_key in ("a", "b"):
        label = f"t2 {name} 384 px ({cfg_key})"
        kern = train_run(make, cfg_key, KERNELS, f"{label} kernels", b384,
                         freeze, dev, card)
        for i, launches in enumerate(kern[3]):
            check_launches(f"{label} step {i}", launches, t2_expect[cfg_key])
        twin = train_run(make, cfg_key, TWINS, f"{label} twins", b384,
                         freeze, dev, card)
        if any(twin[3]):
            raise AssertionError(f"twins launched {twin[3]}")
        dloss, cos, g_worst, p_worst = versus(kern, twin)
        print(f"{label}: launches per step {kern[3][0]} (K10 at (16, 576, "
              f"3072))", flush=True)
        print(report(label, dloss, cos, g_worst, p_worst, card), flush=True)
        slices_ok = g_worst[1] <= MTL_GRAD_ERR and p_worst[1] <= MTL_PARAM_LR
        if (max(dloss) > MTL_DLOSS[cfg_key] or min(cos.values()) < 0.99
                or (cfg_key == "a" and not slices_ok)):
            raise AssertionError(f"{label}: kernels vs twins disagree")
        state[("t2", cfg_key, "launches")] = kern[3][0]
        del kern, twin
        torch.cuda.empty_cache()
        lap(f"t2 ({cfg_key})")
    state["t2"] = (make, b384)

    # ---- (t3) so400m-512 MTL
    so, so_layers, so_freeze, so_b = "so400m-512", 27, 24, 8
    b512 = mtl_batches_at(dev, 512, so_b, LARGE_STEPS, 33)
    t3_tree = mtl_params(dev, seed=0, cfg_name=so)

    def make_so(cfg_key, ks=KERNELS):
        return build_mtl_trainer(
            fresh(t3_tree), cfg_name=so, freeze_below=so_freeze,
            seg_layers=(2, 6, 10, -1), embed_dim=256, lr=MTL_LR,
            warmup_steps=1, kernels=ks)

    label = f"t3 {so} 512 px (a)"
    kern = train_run(make_so, "a", KERNELS, f"{label} kernels", b512,
                     so_freeze, dev, card)
    t3_expect = {linear.KERNEL: 2 * so_layers, attention.KERNEL: so_layers,
                 mlp.KERNEL_BF16: so_layers, layernorm.KERNEL: 2,
                 attention.KERNEL_BWD_TWIN: so_layers - so_freeze}
    for i, launches in enumerate(kern[3]):
        check_launches(f"{label} step {i}", launches, t3_expect)
    twin = train_run(make_so, "a", TWINS, f"{label} twins", b512, so_freeze,
                     dev, card)
    if any(twin[3]):
        raise AssertionError(f"twins launched {twin[3]}")
    dloss, cos, g_worst, p_worst = versus(kern, twin)
    print(f"{label}: launches per step {kern[3][0]} (K14 at hidden 4352, "
          f"K10's route: the twin's VJP) ", flush=True)
    print(report(label, dloss, cos, g_worst, p_worst, card), flush=True)
    if max(dloss) > MTL_DLOSS["a"] or min(cos.values()) < 0.99:
        raise AssertionError(f"{label}: kernels vs twins disagree")
    state[("t3", "launches")] = kern[3][0]
    state["t3"] = (make_so, b512)
    del kern, twin
    torch.cuda.empty_cache()
    lap("t3")

    # ---- (t4) the binary trainer at large-384, 384 px
    bg = torch.Generator(device=dev).manual_seed(34)

    def bin_batches(b, steps):
        return [{"pixels": torch.rand((b, 384, 384, 3), generator=bg,
                                      device=dev) * 2 - 1,
                 "labels": (torch.rand((b,), generator=bg, device=dev)
                            < 0.5).float()} for _ in range(steps)]

    # the first LARGE_STEPS of MTL_STEPS batches: the generator's draws as
    # before, so the tower-trained batches below stay the same
    b64 = bin_batches(64, MTL_STEPS)[:LARGE_STEPS]
    # build_binary_trainer's seed-0 tower, built once: each trainer below
    # starts from a copy (entry.init_siglip hands it out for this part)
    tower0 = tree_map(lambda t: t.to(dev),
                      init_siglip(torch.Generator().manual_seed(0),
                                  CONFIGS[name]))
    entry.init_siglip = lambda gen, cfg: fresh(tower0)
    try:
        n_merge = merges(576, layers, DEPLOYED_TOME_R, deployed_floor(576))
        float_fwd = {linear.KERNEL: 2 * layers, attention.KERNEL: layers,
                     mlp.KERNEL_BF16: layers, layernorm.KERNEL: 2}
        variants = {
            "frozen bf16, v5 head, EMA 0.999, mixup 0.2": (
                dict(ema_decay=0.999, mixup_alpha=0.2), float_fwd, 1e-2),
            "frozen W8A8 + deployed ToMe": (
                dict(int8_backbone=True, tome_r=-1,
                     calib_pixels=b64[0]["pixels"][:16]),
                w8a8_launches("FPP", layers, n_merge, tome=False,
                              k6_fits=True), 2e-2),
            # the fast head's LN reads the bf16 pooled features: K4, as
            # JAX's layer_norm sends bf16 rows of a 128 multiple to its
            # Pallas LN
            "frozen bf16, fast head": (
                dict(head="fast"), dict(float_fwd, **{layernorm.KERNEL: 3}),
                1e-2)}
        for vname, (kw, expect, limit) in variants.items():
            def make_b(ks, kw=kw):
                return build_binary_trainer(dev, seed=0, cfg_name=name,
                                            warmup_steps=1, kernels=ks, **kw)
            label = f"t4 {name} 384 px {vname} B=64"
            kern = binary_run(make_b, KERNELS, f"{label} kernels", b64, dev,
                              card, kw.get("ema_decay"))
            for i, launches in enumerate(kern[2]):
                check_launches(f"{label} step {i}", launches, expect)
            twin = binary_run(make_b, TWINS, f"{label} twins", b64, dev,
                              card, kw.get("ema_decay"))
            if any(twin[2]):
                raise AssertionError(f"twins launched {twin[2]}")
            print(f"binary {label}: launches per step {kern[2][0]}",
                  flush=True)
            binary_versus(label, kern, twin, limit, card)
            state[("t4", vname)] = (kern[3], b64)
            state[("t4", vname, "launches")] = kern[2][0]
            del twin
            torch.cuda.empty_cache()
            lap(f"t4 {vname}")

        b8 = bin_batches(8, 2)
        runs = {}
        for remat, ks in ((False, KERNELS), (True, KERNELS), (False, TWINS)):
            def make_t(ks_, remat=remat):
                return build_binary_trainer(dev, seed=0, cfg_name=name,
                                            train_backbone=True, remat=remat,
                                            warmup_steps=1, kernels=ks_)
            label = (f"t4 {name} 384 px tower trained B=8"
                     f"{' remat' if remat else ''} "
                     f"{'twins' if ks is TWINS else 'kernels'}")
            run_ = binary_run(make_t, ks, label, b8, dev, card)
            runs[(remat, ks is TWINS)] = run_[:3]
            if ks is KERNELS:
                expect = dict(float_fwd, **{attention.KERNEL_BWD: layers})
                if remat:
                    expect.update({linear.KERNEL: 4 * layers,
                                   attention.KERNEL: 2 * layers,
                                   mlp.KERNEL_BF16: 2 * layers})
                for i, launches in enumerate(run_[2]):
                    check_launches(f"{label} step {i}", launches, expect)
                print(f"binary {label}: launches per step {run_[2][0]}",
                      flush=True)
                state[("t4", "tower", remat)] = (run_[3], b8)
            elif any(run_[2]):
                raise AssertionError(f"twins launched {run_[2]}")
            del run_
            torch.cuda.empty_cache()
        twin = runs[(False, True)]
        for remat in (False, True):
            label = f"t4 tower trained{' remat' if remat else ''}"
            rel = binary_versus(label, runs[(remat, False)], twin, 1e-2,
                                card)
            if rel > MTL_GRAD_ERR:
                raise AssertionError(f"{label}: leaf gradient error "
                                     f"{rel:.3e}")
        rel = binary_versus("t4 tower trained, remat vs without remat",
                            runs[(True, False)], runs[(False, False)], 1e-2,
                            card)
        if rel > MTL_GRAD_ERR:
            raise AssertionError(f"t4 remat: slice gradient error {rel:.3e}")
        del runs, twin
        torch.cuda.empty_cache()
        lap("t4 tower trained")
    finally:
        entry.init_siglip = init_siglip
    del tower0

    data = os.path.join(tmp, "real_fake")
    real_fake_folder(data, 8, 384, 35)
    save = os.path.join(tmp, "binary_run")
    cli = [sys.executable, "-m", "tpudf_torch.cli.train_binary",
           "--data_dir", data, "--model_size", name, "--batch_size", "16",
           "--device", "cuda", "--save_dir", save]
    t0 = time.perf_counter()
    run = subprocess.run(cli + ["--epochs", "1", "--ema_decay", "0.999",
                                "--mixup_alpha", "0.2"], cwd=root,
                         capture_output=True, text=True, timeout=900)
    if run.returncode != 0:
        raise AssertionError(f"t4 CLI failed: {run.stderr[-4000:]}")
    rows = open(os.path.join(save, "training_log.csv")).read().splitlines()
    t1 = time.perf_counter()
    ev = subprocess.run(cli + ["--evaluate_only", "--resume",
                               os.path.join(save, "best")], cwd=root,
                        capture_output=True, text=True, timeout=900)
    if (ev.returncode != 0 or len(rows) != 2
            or "[evaluate_only]" not in ev.stdout
            or "[resume] restored" not in ev.stdout):
        raise AssertionError(f"t4 CLI: log {rows}; evaluate_only "
                             f"{ev.stdout[-2000:]} {ev.stderr[-2000:]}")
    print(f"t4: python -m tpudf_torch.cli.train_binary --model_size {name} "
          f"(16 training images, one epoch, eval, checkpoint) in "
          f"{t1 - t0:.2f} s; log {rows[1][:160]}; then --evaluate_only "
          f"--resume in {time.perf_counter() - t1:.2f} s: "
          f"{ev.stdout.strip().splitlines()[-1][:160]} [{card}]", flush=True)
    return state


def training_rest_timings(state, card):
    """Phase 4 of the (t) paths: the large-384 MTL step at 384 px, (a)
    kernels vs twins with a profile and (b); so400m-512's MTL step; the
    binary steps at large-384 (frozen bf16 tower at B = 64, W8A8 + ToMe,
    the fast head; the tower trained at B = 8 with and without remat): ms,
    img/s and a profile each (its idle share)."""
    import torch
    from tpudf_torch.ops.routes import TWINS

    def mtl_step(box, batch):
        box["state"], _ = box["step"](box["state"], batch, None, 1.0, 0.5)

    for key, label in ((("t2", "a"), "t2 large-384 384 px (a)"),
                       (("t2", "b"), "t2 large-384 384 px (b)"),
                       (("t3", "a"), "t3 so400m-512 512 px (a)")):
        make, batches = state[key[0]]
        st, step, _ = make(key[1])
        box = {"state": st, "step": step}
        b = batches[0]["pixels"].shape[0]
        if key == ("t2", "a"):
            st, step, _ = make("a", TWINS)
            tbox = {"state": st, "step": step}
            k_ms, t_ms = paired_ms(lambda: mtl_step(box, batches[0]),
                                   lambda: mtl_step(tbox, batches[0]),
                                   iters=5, twin_iters=3)
            twin = f"; twins {t_ms:.3f} ms"
            del tbox
        else:
            k_ms, twin = cuda_ms(lambda: mtl_step(box, batches[0]), iters=5,
                                 warmup=1), ""
        print(f"{label} train step B={b}: kernels {k_ms:.3f} ms = "
              f"{b * 1e3 / k_ms:.1f} img/s{twin} [{card}]", flush=True)
        if key != ("t2", "b"):
            profile(lambda: mtl_step(box, batches[0]), f"{label} train "
                    f"step B={b}", card, top=16 if key == ("t2", "a") else 8)
        del box, st, step
        torch.cuda.empty_cache()
        lap(f"timing {label}")
    for key, ((tr, st), batches) in [(k, v) for k, v in state.items()
                                     if k[0] == "t4" and len(k) == 2
                                     or k[:2] == ("t4", "tower")]:
        box = {"state": st}
        gen = torch.Generator(device="cuda").manual_seed(7)

        def bstep():
            box["state"], _ = tr.step(box["state"], tr.backbone, batches[0],
                                      gen)

        b = batches[0]["pixels"].shape[0]
        label = (key[1] if len(key) == 2 else
                 "tower trained" + (" remat" if key[2] else ""))
        ms = cuda_ms(bstep, iters=5, warmup=1)
        print(f"t4 binary step large-384 384 px {label} B={b}: kernels "
              f"{ms:.3f} ms = {b * 1e3 / ms:.1f} img/s [{card}]", flush=True)
        # a profile of each but the repeats of another variant's tower
        # (the fast head on the bf16 tower, the remat of the trained one)
        if label not in ("frozen bf16, fast head", "tower trained remat"):
            profile(bstep, f"t4 binary step {label} B={b}", card, top=6)
        del box, tr, st
        state[key] = None
        torch.cuda.empty_cache()
        lap(f"timing t4 {label}")


def trainable_slices(params, attr, freeze):
    """{name: f32 copy} of the trainable parameters (attr "data") or
    their gradients ("grad"): each trainable block layer on its own,
    the fused [q | k | v] leaves cut in thirds. The key biases are left
    out: a key bias adds the same q·b to every score of a row, so its
    gradient is zero in exact arithmetic and holds rounding noise."""
    out = {}

    def walk(tree, path):
        items = (tree.items() if isinstance(tree, dict)
                 else enumerate(tree))
        for k, v in items:
            p = path + (str(k),)
            if isinstance(v, (dict, list)):
                walk(v, p)
                continue
            if p[:2] == ("backbone", "embed"):
                continue
            t = getattr(v, attr).detach()
            blocks = p[:2] == ("backbone", "blocks")
            for layer in (range(freeze, t.shape[0]) if blocks
                          else (None,)):
                x = t if layer is None else t[layer]
                name = ("/".join(p) if layer is None
                        else f"blocks.{layer}/" + "/".join(p[2:]))
                if k not in ("qkv_w", "qkv_b", "in_w", "in_b"):
                    out[name] = x.float().clone()
                    continue
                n = x.shape[-1] // 3
                for j, part in enumerate("qkv"):
                    if not (k.endswith("_b") and part == "k"):
                        out[f"{name}[{part}]"] = (
                            x[..., j * n:(j + 1) * n].float().clone())

    walk(params, ())
    return out


def group_of(name):
    if name.startswith("blocks."):
        return "top blocks"
    return "decoder" if name.startswith("decoder") else "heads"


def frozen_values(params, freeze):
    bb = params["backbone"]
    vals = [t.detach().clone() for t in bb["embed"].values()]

    def rows(tree):
        for v in tree.values():
            if isinstance(v, dict):
                yield from rows(v)
            else:
                yield v.detach()[:freeze].clone()
    return vals + list(rows(bb["blocks"]))


def fresh(tree):
    """A copy of a parameter tree on its device: each trainer built from
    one initial tree (`entry.mtl_params`, an `init_siglip` tower) trains
    its own copy in place."""
    from tpudf_torch.core.precision import tree_map
    return tree_map(lambda t: t.clone(), tree)


def train_run(make, cfg_key, ks, label, batches, freeze, dev, card):
    """Steps on the seeded batches, one a batch: (losses, step-1
    gradients and final parameters by slice, launches per step)."""
    import numpy as np
    import torch
    from tpudf_torch.core.backend import LAUNCHES
    t0 = time.perf_counter()
    state, step, eval_step = make(cfg_key, ks)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    frozen0 = frozen_values(state.params, freeze)
    losses, grads0, per_step = [], None, []
    for i, batch in enumerate(batches):
        LAUNCHES.reset()
        state, m = step(state, batch,
                        torch.Generator(device=dev).manual_seed(i),
                        1.0, 0.5)
        torch.cuda.synchronize()
        per_step.append(LAUNCHES.snapshot())
        losses.append(float(m["loss"]))
        if i == 0:
            grads0 = trainable_slices(state.params, "grad", freeze)
    frozen_ok = all(torch.equal(a, b) for a, b in zip(
        frozen0, frozen_values(state.params, freeze)))
    cls_logits, seg_probs = eval_step(state.params,
                                      batches[0]["pixels"])
    torch.cuda.synchronize()
    b, size = batches[0]["mask"].shape[:2]
    if not (np.isfinite(losses).all() and frozen_ok
            and cls_logits.shape == (b, 3)
            and seg_probs.shape == (b, size, size)
            and torch.isfinite(cls_logits).all()
            and ((seg_probs >= 0) & (seg_probs <= 1)).all()):
        raise AssertionError(
            f"trainer {label}: losses {losses}, frozen bit-identical "
            f"{frozen_ok}, eval {tuple(cls_logits.shape)} "
            f"{tuple(seg_probs.shape)}")
    print(f"trainer {label}: build {build_s:.2f} s; losses "
          f"{['%.6f' % v for v in losses]}; frozen bit-identical after "
          f"{len(batches)} steps; eval finite, seg probs in [0, 1] [{card}]",
          flush=True)
    final = trainable_slices(state.params, "data", freeze)
    del state, step, eval_step, frozen0
    torch.cuda.empty_cache()
    return losses, grads0, final, per_step


def versus(run, ref):
    """A run against the twins' run: |Δloss| per step, the step-1
    gradient cosine per group, the worst slice's step-1 gradient error
    ‖g − g_twin‖ / ‖g_twin‖, and the worst slice's mean |p − p_twin|
    after the 5 steps in units of lr (a slice, not a leaf's tail:
    Adam steps each parameter by about lr, so a mean near 0 means few
    of them moved otherwise)."""
    import torch
    import torch.nn.functional as F
    (lk, gk, pk, _), (lt, gt, pt, _) = run, ref
    dloss = [abs(a - b) for a, b in zip(lk, lt)]
    cos = {}
    for grp in ("top blocks", "heads", "decoder"):
        names = [n for n in gt if group_of(n) == grp]
        cos[grp] = float(F.cosine_similarity(
            torch.cat([gk[n].flatten() for n in names]),
            torch.cat([gt[n].flatten() for n in names]), dim=0))
    rel = {n: float(torch.linalg.vector_norm(gk[n] - gt[n])
                    / torch.linalg.vector_norm(gt[n])) for n in gt}
    dp = {n: float((pk[n] - pt[n]).abs().mean()) / MTL_LR for n in pt}
    g_worst = max(rel, key=rel.get)
    p_worst = max(dp, key=dp.get)
    return dloss, cos, (g_worst, rel[g_worst]), (p_worst, dp[p_worst])


def report(label, dloss, cos, g_worst, p_worst, card):
    return (f"trainer {label}: |Δloss| vs twins per step "
            f"{['%.3e' % d for d in dloss]}; step-1 gradient cosine "
            + ", ".join(f"{k} {v:.6f}" for k, v in cos.items())
            + f"; worst slice step-1 gradient error {g_worst[1]:.3e} "
            f"({g_worst[0]}); worst slice mean |Δp| after {len(dloss)} "
            f"steps {p_worst[1]:.4f} lr ({p_worst[0]}) [{card}]")


# Heads of 16, 32 and 256 (phase 2h, ROADMAP Queue C 1) and of 384 to
# 1280 (Queue C 2): K9, 9b, K10, and K1 / K6 through the W8A8 layer at W =
# heads x head_dim (768 to 1280): (heads, head_dim). K9 and 9b at S = 576
# and a ragged 577; K10, K1 and K6 (JAX's routes need S % 8 == 0 there) at
# 576 and 584
HEADDIM_CASES = [(48, 16), (24, 32), (3, 256), (2, 384), (2, 640),
                 (1, 1280)]
HEADDIM_S_K9 = (576, 577)
HEADDIM_S_K1 = (576, 584)
# K10 at heads of 16, 32 and 256: its largest error from the function in
# float64 at most this many times the twin's own. A per-element rule on
# kernel - twin (atol 1e-2 + rtol 2^-7, phase 2d's) does not hold there: at
# 48 heads of 16, S 576, one element in 2.65 M fell 1.709e-2 from the twin
# with the kernel and the twin equally far (3.092e-2) from float64 (PERF.md)
K10_F64_FACTOR = 2.0


def pad_fault(fn, qkv, heads, hd, scale, *more):
    """The padded route of K9, 9b and K10 with a planted fault: each head
    padded to 64 columns with values of std 1.5 left in the padding in
    place of zeros (a constant would shift every score of a row alike and
    leave the softmax as it is), the kernel run at 64 with the true scale,
    the output sliced."""
    import torch
    from tpudf_torch.ops import attention
    to = attention.PAD_HEAD_DIM
    g = torch.Generator(device=qkv.device).manual_seed(53)

    def pad(t):
        p = attention.pad_heads(t, heads, hd, to)
        n = p.shape[-1] // (heads * to)
        p = p.reshape(*p.shape[:-1], n, heads, to).clone()
        junk = torch.randn(p[..., hd:].shape, generator=g, device=p.device)
        p[..., hd:] = (1.5 * junk).to(p.dtype)
        return p.reshape(*p.shape[:-3], n * heads * to)

    out = fn(pad(qkv), *(pad(m) for m in more), heads, to, scale)
    return attention.unpad_heads(out, heads, hd, to)


def slice_dropped(out, heads, hd, parts=1):
    """A head of 256 or more with its second 128-column slice never
    computed (its columns zero): what a column split that dropped a slice
    returns."""
    o = out.clone().reshape(*out.shape[:-1], parts, heads, hd)
    o[..., 128:256] = 0
    return o.reshape(out.shape)


def chunk_skipped(qkv, heads, hd):
    """qkv with each head's q columns 128-255 zeroed: the scores of a wide
    head whose second 128-deep chunk the sum over the depth skipped."""
    t = qkv.clone().reshape(*qkv.shape[:-1], 3, heads, hd)
    t[..., 0, :, 128:256] = 0
    return t.reshape(qkv.shape)


def block_scale_wrong(out, bad, heads, hd, parts=1):
    """out with rows 64-127 of head 0 (in each of its parts) taken from
    `bad`, a run at a wrong scale: one 64-row block of one head with the
    wrong scale."""
    o = out.clone().reshape(*out.shape[:2], parts, heads, hd)
    o[:, 64:128, :, 0] = bad.reshape(o.shape)[:, 64:128, :, 0]
    return o.reshape(out.shape)


def k10_f64(qkv, g, heads, hd, scale):
    """K10's function in float64 on its bf16 inputs: the VJP of the
    attention with no rounding between the products, (B, S, 3W) [dq | dk |
    dv]."""
    import torch
    b, s, w3 = qkv.shape
    w = w3 // 3

    def heads_first(t):
        return t.reshape(b, s, heads, hd).transpose(1, 2).double()

    q, k, v = (heads_first(qkv[..., i * w:(i + 1) * w]) for i in range(3))
    gh = heads_first(g)
    p = torch.softmax(q @ k.transpose(-1, -2) * scale, dim=-1)
    dp = gh @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * scale
    return torch.cat([t.transpose(1, 2).reshape(b, s, w)
                      for t in (ds @ k, ds.transpose(-1, -2) @ q,
                                p.transpose(-1, -2) @ gh)], dim=-1)


def headdim_checks(dev, card):
    """Phase 2h: K9, 9b and K10 (padded to 64 at heads of 16 and 32, native
    at 256 and on their wide kernels at 384-1280) and K1 / K6 (K1 padded
    to 64 at 16 and 32; K6 native there, at 256 in two 128-column slices
    and at the wide heads as two launches) at HEADDIM_CASES, on sharp
    attention inputs (q, k, v of std 1.5), with and without the key bias
    where the kernel takes one, one launch each, to the card rules of
    phases 2b / 2d / 2f: K9 and 9b at most ATTN_SHARE of the outputs a bf16
    step apart (K9 also within atol 1e-2 + rtol 2^-7), K10 at most
    ATTN_SHARE apart and its largest error from the function in float64
    within K10_F64_FACTOR of the twin's, K1 and K6 within atol 5e-2 + rtol
    2e-2 and ATTN_REL of the attention part; each check shown to fail on
    planted faults: the scale of the padded head (64^-0.5 in place of
    hd^-0.5; at 256 and wider the scale x0.75), a padded column left
    non-zero, the second column slice dropped (at 256 and wider), at the
    wide heads a 128-deep chunk of the scores skipped and one 64-row block
    of one head at the wrong scale, the bias dropped, and at the ragged S
    the keys past S unmasked."""
    import torch
    from tpudf_torch.core.backend import LAUNCHES
    from tpudf_torch.ops import attention, int8_block
    print("phase 2h: K1, K6, K9, 9b and K10 at heads of 16, 32, 256 and "
          "384-1280", flush=True)
    g = torch.Generator(device=dev).manual_seed(51)

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=g, device=dev) * std

    def once(label, counter, fn):
        LAUNCHES.reset()
        out = fn()
        torch.cuda.synchronize()
        check_launches(label, LAUNCHES.snapshot(), {counter: 1})
        return out

    b = 2
    for heads, hd in HEADDIM_CASES:
        w = heads * hd
        scale = hd ** -0.5
        padded = hd in attention.PADDED_HEAD_DIMS
        wide = hd in attention.WIDE_HEAD_DIMS
        bad_sd = (attention.PAD_HEAD_DIM ** -0.5 if padded
                  else 0.75 * scale)
        bad_name = "scale 64^-0.5" if padded else "scale x0.75"
        p = w8a8_layer(randn, dev, w, heads, hd, 4 * w)
        for s in sorted({*HEADDIM_S_K9, *HEADDIM_S_K1}):
            qkv = sharp_qkv(randn, b, s, heads, hd, hd)
            x = randn(b, s, w).to(torch.bfloat16)
            lb = torch.log(torch.randint(1, 9, (b, s), generator=g,
                                         device=dev).float())
            tag = f"{(b, s, 3 * w)} {heads}x{hd}"
            skipped = chunk_skipped(qkv, heads, hd) if wide else None
            if s in HEADDIM_S_K9:
                for bias in (None, lb):
                    k9 = lambda sc, bi: attention.attention_qkv(
                        qkv, heads, hd, sc, logit_bias=bi)
                    got = once(f"K9 {tag}", attention.KERNEL,
                               lambda: k9(scale, bias))
                    ref = attention.attention_qkv_reference(
                        qkv, heads, hd, scale, logit_bias=bias)
                    faults = {bad_name: k9(bad_sd, bias)}
                    if bias is not None:
                        faults["bias dropped"] = k9(scale, None)
                    elif s % 64:
                        faults["keys unmasked"] = keys_unmasked(
                            attention.attention_qkv_reference, qkv, heads,
                            hd, scale)
                    if padded and bias is None:
                        faults["padded column non-zero"] = pad_fault(
                            attention.attention_qkv, qkv, heads, hd, scale)
                    if not padded:
                        faults["slice dropped"] = slice_dropped(got, heads,
                                                                hd)
                    if wide:
                        faults["chunk skipped"] = (
                            attention.attention_qkv_reference(
                                skipped, heads, hd, scale, logit_bias=bias))
                        faults["64-row block's scale"] = block_scale_wrong(
                            got, faults[bad_name], heads, hd)
                    label = f"K9 {tag} bias={bias is not None}"
                    check_close(label, got, ref, atol=1e-2, rtol=2 ** -7)
                    held_check(f"{label}, share > 1 bf16 step", share_apart,
                               ATTN_SHARE, got, ref, faults, card)
                i8 = lambda sc: attention.attention_qkv_int8(qkv, heads, hd,
                                                             sc)
                got = once(f"9b {tag}", attention.KERNEL_INT8,
                           lambda: i8(scale))
                ref = attention.attention_qkv_int8_reference(qkv, heads, hd,
                                                             scale)
                faults = {
                    "aq over 64-row tiles":
                        attention.attention_qkv_int8_reference(
                            qkv, heads, hd, scale, q_block=64),
                    bad_name: i8(bad_sd)}
                if s % 64:
                    faults["keys unmasked"] = keys_unmasked(
                        attention.attention_qkv_int8_reference, qkv, heads,
                        hd, scale)
                if padded:
                    faults["padded column non-zero"] = pad_fault(
                        attention.attention_qkv_int8, qkv, heads, hd, scale)
                else:
                    faults["slice dropped"] = slice_dropped(got, heads, hd)
                if wide:
                    faults["chunk skipped"] = (
                        attention.attention_qkv_int8_reference(
                            skipped, heads, hd, scale))
                    faults["64-row block's scale"] = block_scale_wrong(
                        got, faults[bad_name], heads, hd)
                held_check(f"9b {tag}, share > 1 bf16 step", share_apart,
                           ATTN_SHARE, got, ref, faults, card)
            if s not in HEADDIM_S_K1:
                continue
            # K10
            q10 = randn(b, s, 3 * heads * hd, std=1.5).to(torch.bfloat16)
            gout = randn(b, s, heads * hd).to(torch.bfloat16)
            k10 = lambda sc: attention.attention_qkv_bwd(q10, gout, heads,
                                                         hd, sc)
            got = once(f"K10 {tag}", attention.KERNEL_BWD,
                       lambda: k10(scale))
            ref = attention.attention_qkv_bwd_reference(q10, gout, heads, hd,
                                                        scale)
            faults = {bad_name: k10(bad_sd),
                      "D dropped": k10_twin_fault(q10, gout, heads, hd,
                                                  scale, "D")}
            if s % 64:
                faults["keys unmasked"] = k10_twin_fault(
                    q10, gout, heads, hd, scale, "unmasked")
            if padded:
                faults["padded column non-zero"] = pad_fault(
                    attention.attention_qkv_bwd, q10, heads, hd, scale,
                    gout)
            else:
                faults["slice dropped"] = slice_dropped(got, heads, hd, 3)
            if wide:
                faults["chunk skipped"] = (
                    attention.attention_qkv_bwd_reference(
                        chunk_skipped(q10, heads, hd), gout, heads, hd,
                        scale))
                faults["64-row block's scale"] = block_scale_wrong(
                    got, faults[bad_name], heads, hd, 3)
            exact = k10_f64(q10, gout, heads, hd, scale)
            twin_err = max_abs(ref, exact)
            held_check(f"K10 {tag}, max |Δ| from f64 over the twin's "
                       f"({twin_err:.3e})",
                       lambda a, e: max_abs(a, e) / twin_err, K10_F64_FACTOR,
                       got, exact, faults, card)
            held_check(f"K10 {tag}, share > 1 bf16 step", share_apart,
                       ATTN_SHARE, got, ref, faults, card)
            # K1 and K6 through the W8A8 layer
            args = (x, p["ln1"], p["qkv_wq"], p["qkv_b"], p["out_wq"],
                    p["out_b"], p["a_qkv"], p["a_out"], heads, hd, 1e-6)
            ln_qkv = int8_block.ln_qkv_reference(
                x, p["ln1"], p["qkv_wq"], p["qkv_b"], p["a_qkv"])

            def k1_twin_with(o_fn, bias):
                o = o_fn(ln_qkv, bias)
                return int8_block._out_proj_reference(
                    o, x, p["out_wq"], p["out_b"], p["a_out"])

            def twin_o(q, bi, sc=scale):
                return attention.attention_qkv_reference(q, heads, hd, sc,
                                                         logit_bias=bi)

            for bias in (None, lb):
                k1 = lambda sc, bi: int8_block.attn_sublayer_int8(
                    *args, sc, logit_bias=bi)
                got = once(f"K1 {tag}", int8_block.KERNEL,
                           lambda: k1(scale, bias))
                ref = int8_block.attn_sublayer_reference(
                    *args, scale, logit_bias=bias)
                faults = {bad_name: k1(bad_sd, bias)}
                if bias is not None:
                    faults["bias dropped"] = k1(scale, None)
                elif s % 64:
                    faults["keys unmasked"] = k1_twin_with(
                        lambda q, bi: keys_unmasked(
                            attention.attention_qkv_reference, q, heads, hd,
                            scale), bias)
                if not padded:
                    faults["slice dropped"] = k1_twin_with(
                        lambda q, bi: slice_dropped(twin_o(q, bi), heads,
                                                    hd), bias)
                if wide:
                    faults["chunk skipped"] = k1_twin_with(
                        lambda q, bi: twin_o(chunk_skipped(q, heads, hd),
                                             bi), bias)
                    faults["64-row block's scale"] = k1_twin_with(
                        lambda q, bi: block_scale_wrong(
                            twin_o(q, bi), twin_o(q, bi, bad_sd), heads,
                            hd), bias)
                label = f"K1 {tag} bias={bias is not None}"
                check_close(label, got, ref, atol=5e-2, rtol=2e-2)
                held_check(f"{label} |Δ|/|attention part|", rel_part(x),
                           ATTN_REL, got, ref, faults, card)
            args6 = (qkv, x, p["out_wq"], p["out_b"], p["a_out"], heads, hd)
            assert int8_block.attn_out_int8_fits(s, heads * hd, w, hd)
            k6_counter = (int8_block.KERNEL_ATTN_OUT_SPLIT if wide
                          else int8_block.KERNEL_ATTN_OUT)
            got = once(f"K6 {tag}", k6_counter,
                       lambda: int8_block.attn_out_int8(*args6, scale))
            ref = int8_block.attn_out_reference(*args6, scale)

            def k6_twin_with(o):
                return int8_block._out_proj_reference(
                    o, x, p["out_wq"], p["out_b"], p["a_out"])

            faults = {bad_name: int8_block.attn_out_int8(*args6, bad_sd)}
            if s % 64:
                faults["keys unmasked"] = k6_twin_with(keys_unmasked(
                    attention.attention_qkv_reference, qkv, heads, hd,
                    scale))
            if not padded:
                faults["slice dropped"] = k6_twin_with(slice_dropped(
                    twin_o(qkv, None), heads, hd))
            if wide:
                faults["chunk skipped"] = k6_twin_with(twin_o(skipped, None))
                faults["64-row block's scale"] = k6_twin_with(
                    block_scale_wrong(twin_o(qkv, None),
                                      twin_o(qkv, None, bad_sd), heads, hd))
            label = f"K6 {tag}{' (two launches)' if wide else ''}"
            check_close(label, got, ref, atol=5e-2, rtol=2e-2)
            held_check(f"{label} |Δ|/|attention part|", rel_part(x),
                       ATTN_REL, got, ref, faults, card)
            del qkv, q10, x, lb, gout, got, ref, faults, exact, skipped
            torch.cuda.empty_cache()


# K1's attention launch alone (phase 2j, `k1_attention_checks`): the first
# layer of each detect core phase 4 times (base-256 B = 256, large-384 B =
# 128, so400m-512 B = 64, whose heads of 72 sit in 128-wide slots and run
# on the 80-wide tile) and each at B = 8, beside K9 at that shape: (label,
# B, S, heads, head_dim, live columns, softmax scale)
K1_ATTN_PATHS = [("base-256", 256, 256, 12, 64, 64, None),
                 ("large-384", 128, 576, 16, 64, 64, None),
                 ("so400m-512", 64, 1024, 16, 128, 72, 72 ** -0.5)]
# its codes against the twin's, the int8 codes of the f32 o: at most
# K1_CODE_SHARE of them differ, none by more than one (f32 sums in another
# order and 127 / act rounded another way move a code at a rounding tie)
K1_CODE_SHARE = 1e-3
K1_PAD_CODE = 85                # the pre-filled buffer's code


def code_share(got, ref):
    """The share of int8 codes of got and ref that differ."""
    return float((got != ref).float().mean())


def held_codes(label, got, ref, faults, card):
    """K1's attention codes within K1_CODE_SHARE of the twin's, none more
    than one apart; every planted fault's beyond the share."""
    held_check(label, code_share, K1_CODE_SHARE, got, ref, faults, card)
    step = int((got.int() - ref.int()).abs().max())
    if step > 1:
        raise AssertionError(f"{label}: a code {step} from the twin's")


def k1_attention_checks(rec, dev, card):
    """Phase 2j: K1's attention launch alone (`int8_block.attention_i8`) at
    K1_ATTN_PATHS. At B = 8, on q, k, v of std 1.5 in the live columns,
    with and without the key bias: its codes within K1_CODE_SHARE of the
    twin's, the check shown to fail on planted faults (the scale; the bias
    dropped; on the 80-wide tile the codes of columns 80-127 left as a
    pre-filled buffer had them, and a head whose columns 72-79 are not
    zero read as if they were, which the twin reads). Then its device time
    at each path's shape and at B = 8, beside its bound (operations over
    the bf16 peak or bytes over 3.35 TB/s, whichever is larger, on the
    live columns and on the tile's computed ones), SDPA on the same live
    q, k, v with a bf16 output (the nearest single PyTorch call) and, at B
    = 8, K9 at the same qkv; into K1's row of the kernels line."""
    import torch
    import torch.nn.functional as F
    from tpudf_torch.models.siglip import CONFIGS
    from tpudf_torch.ops import attention, int8_block
    print("phase 2j: K1's attention launch alone (wgmma + TMA)", flush=True)
    g = torch.Generator(device=dev).manual_seed(61)
    act = torch.tensor(6.0, device=dev)

    def qkv_of(b, s, heads, hd, live):
        t = torch.randn((b, s, 3, heads, hd), generator=g, device=dev) * 1.5
        t[..., live:] = 0.0
        return t.reshape(b, s, -1).to(torch.bfloat16)

    for label, bp, s, heads, hd, live, scale in K1_ATTN_PATHS:
        sd = scale if scale is not None else hd ** -0.5
        bad_sd = hd ** -0.5 if scale is not None else 0.75 * sd
        arg = None if live == hd else live
        width, hs = int8_block.i8_attn_tile(hd, arg)
        b = 8
        qkv = qkv_of(b, s, heads, hd, live)
        lb = torch.log(torch.randint(1, 9, (b, s), generator=g,
                                     device=dev).float())
        tag = f"{label} {(b, s, 3 * heads * hd)} tile {width}"

        def k1(q=qkv, sc=sd, bias=None, out=None):
            return int8_block.attention_i8(q, heads, hd, act, sc,
                                           logit_bias=bias, live=arg,
                                           out=out)

        for bias in (None, lb):
            ref = int8_block.attention_i8_reference(qkv, heads, hd, act, sd,
                                                    logit_bias=bias)
            faults = {"scale": k1(sc=bad_sd, bias=bias)}
            if bias is not None:
                faults["bias dropped"] = k1()
            if width != hd and bias is None:
                # the output buffer pre-filled with non-zero codes: the
                # kernel must write columns 80-127 of each head
                buf = torch.full((b * s, heads * hs), K1_PAD_CODE,
                                 dtype=torch.int8, device=dev)
                got = k1(out=buf)
                unwritten = got.clone().reshape(b * s, heads, hs)
                unwritten[..., width:] = K1_PAD_CODE
                faults["columns 80-127 unwritten"] = unwritten.reshape(
                    got.shape)
            else:
                got = k1(bias=bias)
            torch.cuda.synchronize()
            held_codes(f"K1 attention {tag} bias={bias is not None}, codes "
                       f"differing", got, ref, faults, card)
        if width != hd:
            # columns 72-79 not zero: the 80-wide tile reads them, as the
            # twin does; a tile that took only the live 72 would not
            q80 = qkv.clone().reshape(b, s, 3, heads, hd)
            q80[..., live:width] = (torch.randn(
                q80[..., live:width].shape, generator=g, device=dev)
                * 1.5).to(torch.bfloat16)
            q80 = q80.reshape(qkv.shape)
            ref = int8_block.attention_i8_reference(q80, heads, hd, act, sd)
            got = k1(q=q80)
            torch.cuda.synchronize()
            held_codes(f"K1 attention {tag}, columns 72-79 non-zero, codes "
                       f"differing", got, ref,
                       {"columns 72-79 skipped": k1()}, card)
            del q80
        del ref, got, faults
        # timings: at B = 8 (beside K9 there, and with the key bias that
        # ToMe's layers pass) and at the path's B
        layers = CONFIGS[label].layers
        for bt in (8, bp):
            q = qkv if bt == 8 else qkv_of(bt, s, heads, hd, live)
            ms = device_ms(lambda: k1(q=q))
            qv, kv_, vv = (q[..., i * heads * hd:(i + 1) * heads * hd]
                           .reshape(bt, s, heads, hd)[..., :live]
                           .transpose(1, 2).contiguous() for i in range(3))
            sdpa = device_ms(lambda: F.scaled_dot_product_attention(
                qv, kv_, vv, scale=sd))
            bounds = {}
            for d in sorted({live, width}):
                bounds[d] = bound({"bf16": 4 * bt * heads * s * s * d},
                                  bt * s * 3 * heads * d * 2
                                  + bt * s * heads * hs)
            k9 = (device_ms(lambda: attention.attention_qkv(q, heads, hd,
                                                            sd))
                  if bt == 8 else None)
            ms_bias = device_ms(lambda: k1(q=q, bias=lb)) if bt == 8 else None
            shape = (bt, s, 3 * heads * hd)
            print(f"  K1 attention launch alone {label} {shape} tile "
                  f"{width} ({live} live): device {ms:.4f} ms; bound "
                  + ", ".join(f"{v[0]:.4f} ms ({v[1]}) on {d} columns"
                              for d, v in bounds.items())
                  + f"; SDPA bf16 {sdpa:.4f} ms ({ms / sdpa:.2f}x)"
                  + ("" if k9 is None else f"; K9 at this qkv {k9:.4f} ms "
                     f"({ms / k9:.2f}x); with the key bias {ms_bias:.4f} "
                     f"ms")
                  + f"; {layers} launches a forward [{card}]", flush=True)
            rec.rows["K1"].setdefault("attention_launch", []).append(
                {"path": label, "shape": shape, "tile": width, "live": live,
                 "device_ms": ms, "bound_ms": bounds[live][0],
                 "bound_by": bounds[live][1],
                 "bound_ms_computed": bounds[width][0], "library_ms": sdpa,
                 "k9_device_ms": k9, "device_ms_bias": ms_bias,
                 "launches": layers})
            del qv, kv_, vv
            if bt != 8:
                del q
        del qkv, lb
        torch.cuda.empty_cache()


# the int8 GEMM launch (phase 2i): (M, K, N) of its checks, the tile's
# edges (M ragged: 300, 2049; N: 768, 1152 and 4352 (N % 256 == 128: the
# half tile where the 256-wide tiles run), 2304, 3072; K: 768, 1152, 4352,
# and 832 (a 64-deep tail of the 128-deep slices)) and the paths' shapes
# (base-256's QKV and fc2 at B = 256);
# at most I8_SHARE of the outputs not bit-equal to the twin's epilogue on
# the kernel's own int32 sums, each within one bf16 step (one code), the
# int32 mode bit-equal to torch._int_mm
I8_SHAPES = [(300, 768, 768), (300, 1152, 1152), (2049, 832, 2304),
             (300, 4352, 3072), (2049, 1152, 4352), (2049, 4352, 1152),
             (300, 768, 4352), (65536, 768, 2304), (65536, 3072, 768)]
I8_SHARE = 1e-5


def not_equal_share(a, b):
    """The share of elements of a and b that are not bit-equal."""
    return float((a != b).float().mean())


def i8_epilogue_twin(acc, mode, cs, bias, act, residual=None, act_out=None):
    """The twin's epilogue (gemm_i8.cuh's order, op by op in f32) on int32
    sums `acc`."""
    import torch
    from tpudf_torch.ops import int8_block
    from tpudf_torch.ops.quant import quant_rows
    from tpudf_torch.utils.nn import gelu_tanh
    if mode == 3:
        return acc
    f = acc.float() * ((act / 127.0) * cs.float()) + bias.float()
    if mode == int8_block.GEMM_BF16:
        return f.to(torch.bfloat16)
    if mode == int8_block.GEMM_GELU_I8:
        return quant_rows(gelu_tanh(f), act_out)
    return (residual.float() + f).to(torch.bfloat16)


def wrong_swizzle(wt):
    """The weight as a tile read with the wrong swizzle would see it: each
    row's 16-byte chunk c of every 128-byte K slice taken from chunk c ^
    (row % 8)."""
    import torch
    n, k = wt.shape
    kw = k // 128 * 128                 # whole slices; the tail as it is
    chunks = wt[:, :kw].reshape(n, k // 128, 8, 16)
    idx = torch.arange(8, device=wt.device)[None, :] ^ (
        torch.arange(n, device=wt.device)[:, None] % 8)
    body = torch.gather(chunks, 2, idx[:, None, :, None].expand(
        n, k // 128, 8, 16)).reshape(n, kw)
    return torch.cat([body, wt[:, kw:]], 1).contiguous()


def i8_gemm_checks(dev, card):
    """Phase 2i: the int8 GEMM launch (`int8_block.i8_gemm_cuda`, the wgmma
    + TMA kernel of int8_gemm_sm90.cu) at I8_SHAPES in each mode: kEpiI32
    bit-equal to torch._int_mm; kEpiBf16, kEpiGeluI8 and kEpiResidual
    against the twin's epilogue on the kernel's own int32 sums, at most
    I8_SHARE of the outputs not bit-equal and none more than a bf16 step
    (one code) apart; sum of out^2 within rtol 1e-4 of the sums of its own
    output; each check shown to fail on planted faults: a 128-deep K slice
    skipped (A's columns zeroed), the weight's second box of a tile dropped
    (at a half tile: its only box), the bias, GELU or residual dropped,
    act_out ignored, the weight read with the wrong swizzle."""
    import torch
    from tpudf_torch.ops import _build, int8_block
    print("phase 2i: the int8 GEMM (wgmma + TMA) vs torch._int_mm and its "
          "twin", flush=True)
    g = torch.Generator(device=dev).manual_seed(61)
    lib = _build.load()

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=g, device=dev) * std

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)

    bf = torch.bfloat16
    for m, k, n in I8_SHAPES:
        a8, wt = codes(m, k), codes(n, k)
        cs = (randn(n).abs() * 1e-3 + 1e-3)
        bias = randn(n, std=0.1)
        act = torch.tensor(4.0, device=dev)
        act_out = torch.tensor(3.0, device=dev)
        res = randn(m, n).to(bf)
        acc = torch._int_mm(a8, wt.t())
        k0 = (k // 256) * 128                    # a 128-deep slice mid-way
        a_skip = a8.clone()
        a_skip[:, k0:k0 + 128] = 0
        n0 = (n - 1) // 256 * 256               # the last tile's columns
        half = n - n0 == 128
        wt_box = wt.clone()                      # its second (or only) box
        wt_box[n0 + (0 if half else 128):n0 + 256] = 0
        tile_n = lib.tpudf_i8_gemm_tile_n(m, n)
        torch.cuda.synchronize()

        def run(mode, a_=a8, w_=wt, b_=bias, ss=None, ao=act_out):
            return int8_block.i8_gemm_cuda(
                a_, w_, cs, b_, act, mode, residual=res if mode == 2 else
                None, sumsq=ss, act_out=ao if mode == 1 else None)

        def twin(mode, acc_=acc, b_=bias):
            return i8_epilogue_twin(acc_, mode, cs, b_, act, res, act_out)

        # kEpiI32: bit-equal to torch._int_mm
        got = int8_block.i8_gemm_cuda(a8, wt, None, None, None, 3)
        same = bool(torch.equal(got, acc))
        faults = {"K slice skipped": int8_block.i8_gemm_cuda(
                      a_skip, wt, None, None, None, 3),
                  "weight box dropped": int8_block.i8_gemm_cuda(
                      a8, wt_box, None, None, None, 3),
                  "wrong swizzle": int8_block.i8_gemm_cuda(
                      a8, wrong_swizzle(wt), None, None, None, 3)}
        caught = {f: not torch.equal(v, acc) for f, v in faults.items()}
        print(f"  i8 GEMM {(m, k, n)} tile n {tile_n} kEpiI32: bit-equal to "
              f"torch._int_mm {same}; planted faults caught {caught} "
              f"[{card}]", flush=True)
        if not same or not all(caught.values()):
            raise AssertionError(f"i8 GEMM {(m, k, n)} kEpiI32")
        del got, faults
        ss = torch.zeros(m, device=dev)
        cases = [("kEpiBf16", run(0), twin(0),
                  {"bias dropped": run(0, b_=torch.zeros_like(bias)),
                   "K slice skipped": run(0, a_=a_skip),
                   "weight box dropped": run(0, w_=wt_box),
                   "wrong swizzle": run(0, w_=wrong_swizzle(wt))}),
                 ("kEpiGeluI8", run(1), twin(1),
                  {"GELU dropped": quant_no_gelu(acc, cs, bias, act,
                                                 act_out),
                   "act_out ignored": run(1, ao=act),
                   "K slice skipped": run(1, a_=a_skip)}),
                 ("kEpiResidual", run(2, ss=ss), twin(2),
                  {"residual dropped": run(0),
                   "weight box dropped": run(2, w_=wt_box)})]
        torch.cuda.synchronize()
        for label, got, ref, faults in cases:
            step = (1.0 if got.dtype == torch.int8
                    else bf16_step(torch.maximum(got.float().abs(),
                                                 ref.float().abs())))
            far = int(((got.float() - ref.float()).abs() > step).sum())
            if far:
                raise AssertionError(f"i8 GEMM {(m, k, n)} {label}: {far} "
                                     f"outputs more than one step apart")
            held_check(f"i8 GEMM {(m, k, n)} {label}, share not bit-equal",
                       not_equal_share, I8_SHARE, got, ref, faults, card)
        out = cases[2][1].float()
        own = (out * out).sum(-1)
        err = float(((ss - own).abs() / own.abs().clamp_min(1e-6)).max())
        print(f"  i8 GEMM {(m, k, n)} sum of out^2: max rel err {err:.3e} "
              f"(limit 1e-4) [{card}]", flush=True)
        if err > 1e-4:
            raise AssertionError(f"i8 GEMM {(m, k, n)}: sum of out^2 {err}")
        del a8, wt, res, acc, a_skip, wt_box, cases, ss
        torch.cuda.empty_cache()


def quant_no_gelu(acc, cs, bias, act, act_out):
    """kEpiGeluI8's twin with GELU dropped."""
    from tpudf_torch.ops.quant import quant_rows
    f = acc.float() * ((act / 127.0) * cs.float()) + bias.float()
    return quant_rows(f, act_out)


# the int8 GEMM launch alone at the paths' shapes (phase 2i timings): (path,
# M, K, N, mode): probe 16's k_pure and k_noquant, and K1's and K2's four
# products at the first layer of the detect cores (base-256 B = 256,
# large-384 B = 128, so400m-512 B = 64: heads padded to 128, MLP to 4352)
I8_PATHS = [("16 k_pure", 65536, 768, 3072, 3),
            ("16 k_noquant", 65536, 768, 3072, 0)] + [
    (f"{name} {part}", m, k, n, mode)
    for name, m, w, wa, inter in (("base-256 B=256", 65536, 768, 768, 3072),
                                  ("large-384 B=128", 73728, 1024, 1024,
                                   4096),
                                  ("so400m-512 B=64", 65536, 1152, 2048,
                                   4352))
    for part, k, n, mode in (("QKV", w, 3 * wa, 0), ("out-proj", wa, w, 2),
                             ("fc1", w, inter, 1), ("fc2", inter, w, 2))]


def i8_gemm_path_timings(dev, card):
    """The int8 GEMM launch alone (`tpudf_i8_gemm`; the sum of out^2 with
    the fc2 residual) at I8_PATHS: device time (profiler; CUDA events where
    it records none), beside torch._int_mm alone and with the epilogue as
    PyTorch calls, the bound, TOP/s. Returns {path: (ms, bound ms, bound
    by, torch._int_mm ms)}."""
    import torch
    from tpudf_torch.ops import _build
    g = torch.Generator(device=dev).manual_seed(63)
    lib = _build.load()
    out = {}
    for label, m, k, n, mode in I8_PATHS:
        a8 = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                           dtype=torch.int8)
        wt = torch.randint(-127, 128, (n, k), generator=g, device=dev,
                           dtype=torch.int8)
        cs = torch.rand(n, generator=g, device=dev) * 1e-3 + 1e-3
        bias = torch.randn(n, generator=g, device=dev) * 0.1
        act = torch.tensor(4.0, device=dev)
        act_out = torch.tensor(3.0, device=dev)
        res = (torch.randn((m, n), generator=g, device=dev)
               .to(torch.bfloat16) if mode == 2 else None)
        ss = torch.zeros(m, device=dev) if "fc2" in label else None
        out_t = torch.empty((m, n), device=dev, dtype={
            0: torch.bfloat16, 1: torch.int8, 2: torch.bfloat16,
            3: torch.int32}[mode])
        eps = (None, None, None) if mode == 3 else (cs, bias, act)

        def kern():
            _build.call("tpudf_i8_gemm", a8, wt, *eps[:2], eps[2], res,
                        out_t, ss, act_out if mode == 1 else None, m, n, k,
                        mode)
        lib_fn = lambda: torch._int_mm(a8, wt.t())
        parts = lambda: i8_epilogue_twin(torch._int_mm(a8, wt.t()), mode,
                                         cs, bias, act, res, act_out)
        dev_ms, lib_ms = device_ms(kern), device_ms(lib_fn)
        parts_ms = device_ms(parts) if mode != 3 else lib_ms
        by = "device"
        if not dev_ms or not lib_ms:
            dev_ms, lib_ms, parts_ms, by = (cuda_ms(kern, 10),
                                            cuda_ms(lib_fn, 10),
                                            cuda_ms(parts, 10), "events")
        out_b = m * n * (4 if mode == 3 else 1 if mode == 1 else 2)
        b_ms, b_by = bound({"int8": 2 * m * k * n},
                           nbytes(a8, wt, res) + out_b)
        tile = lib.tpudf_i8_gemm_tile_n(m, n)
        print(f"  i8 GEMM {label} ({m}, {k}, {n}) mode {mode} tile n {tile}:"
              f" {by} {dev_ms:.4f} ms, torch._int_mm {lib_ms:.4f} ms "
              f"({dev_ms / lib_ms:.2f}x), with the epilogue as PyTorch calls"
              f" {parts_ms:.4f} ms ({dev_ms / parts_ms:.2f}x); bound "
              f"{b_ms:.4f} ms ({b_by}, {b_ms / dev_ms:.2f} of it), "
              f"{2 * m * k * n / dev_ms / 1e9:.1f} TOP/s [{card}]",
              flush=True)
        out[label] = (dev_ms, b_ms, b_by, lib_ms)
        del a8, wt, res, ss, out_t
        torch.cuda.empty_cache()
    return out


# K4 at the shapes its paths give it (phase 2i timings): rows, width
LN_SHAPES = [(8192, 768), (8192, 1152), (8 * 53 * 256, 768)]


def ln_timings(dev, card):
    """K4 (`layernorm.layer_norm_fused`) alone at LN_SHAPES with its scale
    and bias in f32 (the detect core's) and in bf16 (engine A's): device
    time (profiler; CUDA events where it records none) beside
    F.layer_norm's, the bound (the bytes of x, the output and the
    parameters) and its share. Where x and the output fit in the card's L2
    (L2_BYTES) they stay there across the timed calls, so the bound by
    HBM bytes does not hold there: its share is printed for the largest
    shape only. Returns {(rows, width, dtype): (ms, bound ms, F.layer_norm
    ms)}."""
    import torch
    import torch.nn.functional as F
    from tpudf_torch.ops import layernorm
    g = torch.Generator(device=dev).manual_seed(65)
    out = {}
    for rows, w in LN_SHAPES:
        x = (torch.randn((rows, w), generator=g, device=dev) * 3.0
             + 0.5).to(torch.bfloat16)
        for dt in (torch.float32, torch.bfloat16):
            sc = (1.0 + torch.randn(w, generator=g, device=dev) * 0.1).to(dt)
            bi = (torch.randn(w, generator=g, device=dev) * 0.1).to(dt)
            g16, b16 = sc.to(torch.bfloat16), bi.to(torch.bfloat16)
            kern = lambda: layernorm.layer_norm_fused(x, sc, bi)
            lib = lambda: F.layer_norm(x, (w,), g16, b16, 1e-6)
            got, ref = kern(), layernorm.layer_norm_reference(x, sc, bi)
            torch.cuda.synchronize()
            check_close(f"K4 ({rows}, {w}) {dt}", got, ref, atol=1e-6,
                        rtol=2 ** -7)
            dev_ms, lib_ms = device_ms(kern), device_ms(lib)
            by = "device"
            if not dev_ms or not lib_ms:
                dev_ms, lib_ms, by = cuda_ms(kern, 20), cuda_ms(lib, 20), \
                    "events"
            b_ms, _ = bound({"f32": K4_OPS_PER_ELEMENT * x.numel()},
                            nbytes(x, sc, bi, got))
            name = "f32" if dt == torch.float32 else "bf16"
            share = (f"{b_ms / dev_ms:.3f} of it"
                     if nbytes(x, got) > L2_BYTES else
                     "L2-resident, so not a bound here")
            print(f"  K4 ({rows}, {w}) params {name}: {by} {dev_ms:.4f} ms,"
                  f" F.layer_norm {lib_ms:.4f} ms ({dev_ms / lib_ms:.2f}x);"
                  f" bound {b_ms:.4f} ms (HBM bytes), {share} [{card}]",
                  flush=True)
            out[(rows, w, name)] = (dev_ms, b_ms, lib_ms)
        del x
        torch.cuda.empty_cache()
    return out


# K5 and 9b on wgmma + TMA (phase 2k, `k5_9b_checks`). K5 at the shapes its
# phases 2 and 2b do not reach: 65536 rows (blocks walk several row tiles
# and rebuild their panel at each), a ragged M (8 x 257 rows), a 64-deep K
# tail (W = 832) and the widest panel (W = 1280): (M, W, N)
K5_SHAPES = [(65536, 1152, 6144), (8 * 257, 1152, 6144), (2049, 832, 2304),
             (1000, 1280, 3840)]
# K5's launch alone at the paths' shapes: the B = 8 detect cores' QKV and
# so400m-512's at B = 64 (heads padded to 128): (path, M, W, N)
K5_TIMED = [("base-256 B=8", 2048, 768, 2304),
            ("large-384 B=8", 4608, 1024, 3072),
            ("so400m-512 B=8", 8192, 1152, 6144),
            ("so400m-512 B=64", 65536, 1152, 6144)]
# 9b's wgmma pass: (B, S, heads, head_dim, scale) of its checks (the
# reference route's shapes and a ragged S) and timings
K9B_SHAPES = [(8, 576, 16, 64, None), (8, 1024, 16, 128, 72 ** -0.5),
              (2, 1297, 4, 128, None), (2, 1297, 12, 64, None)]
K9B_TIMED = [("large-384", 8, 576, 16, 64, None),
             ("so400m-512", 8, 1024, 16, 128, 72 ** -0.5)]


def k5_rel(got, ref):
    """max |got - twin| / (5e-2 + 2e-2 |twin|): K5's card rule holds where
    it is at most 1."""
    e = (got.float() - ref.float()).abs() / (5e-2 + 2e-2 * ref.float().abs())
    return float(e.max())


def k5_from_codes(codes, wq, bias, a):
    """K5's twin epilogue on given int8 LN codes (M, W): bf16 out."""
    import torch
    from tpudf_torch.ops.quant import int8_mm
    acc = int8_mm(codes, wq["q"])
    return (acc.float() * ((a / 127.0) * wq["scale"].float())
            + bias.float()).to(torch.bfloat16)


def k5_stale_panel(ref, m, n, sms):
    """K5's output had no block rebuilt its panel after its first unit:
    each later unit's columns computed from the first unit's rows
    (`int8_block.k5_units`)."""
    from tpudf_torch.ops import int8_block
    out = ref.clone()
    t = int8_block.K5_TILE
    stale = 0
    for block in int8_block.k5_units(m, n, sms):
        r0 = block[0][0]
        for rt, c0, c1 in block[1:]:
            if rt == r0:
                continue
            rows = min(t, m - rt * t, m - r0 * t)
            out[rt * t:rt * t + rows, c0 * t:c1 * t] = \
                ref[r0 * t:r0 * t + rows, c0 * t:c1 * t]
            stale += 1
    return out, stale


def k5_9b_checks(rec, dev, card):
    """Phase 2k. K5 at K5_SHAPES against its twin (atol 5e-2 + rtol 2e-2),
    bit-equal to its two-launch form (K8's codes, then the int8 GEMM in
    kEpiBf16) and to itself over repeated launches, its split equal to
    `int8_block.k5_splits`; each shape's check shown to fail on planted
    faults: no block rebuilding its panel after its first unit (where
    blocks walk several row tiles), one 128-deep panel slice left zero, g
    dropped, the act scale ignored by the quant, and one run of each row
    tile's columns not stored into an output pre-filled with 7. 9b's wgmma
    pass at K9B_SHAPES: the pre-pass's codes bit-equal to their plain
    version, the output by phase 2b's share rule (ATTN_SHARE), shown to
    fail on faults planted in the pre-pass's scratch between its launch and
    the main pass's: v8t in natural key order, k8 quantised with the amax
    of each 64-key tile, and at a ragged S non-zero codes past S. Then both
    launches alone: K5 at K5_TIMED beside its bound, its two-launch form
    and the PyTorch parts; 9b's pre-pass and main pass at K9B_TIMED beside
    their bound, K9 and SDPA; device times into K5's and 9b's rows."""
    import torch
    import torch.nn.functional as F
    from tpudf_torch.ops import _build, attention, int8_block, layernorm
    from tpudf_torch.ops.quant import quant_rows, transposed
    print("phase 2k: K5 (LN panel on the int8 wgmma GEMM) and 9b (pre-pass + "
          "int8 wgmma)", flush=True)
    lib = _build.load()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(67)
    bf = torch.bfloat16

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=g, device=dev) * std

    def k5_inputs(m, w, n):
        x = (randn(m, w) * 3.0 + 0.5).to(bf)
        ln = {"scale": 1.0 + randn(w, std=0.1), "bias": randn(w, std=0.1)}
        wq = {"q": torch.randint(-127, 128, (w, n), generator=g, device=dev,
                                 dtype=torch.int8),
              "scale": randn(n).abs() * 1e-3 + 1e-3}
        wq["qT"] = transposed(wq)
        return x, ln, wq, randn(n, std=0.1), torch.tensor(4.0, device=dev)

    # ---- K5: checks and planted faults
    for m, w, n in K5_SHAPES:
        x, ln, wq, bias, a = k5_inputs(m, w, n)
        args = (x, ln, wq, bias, a)
        got = int8_block.ln_qkv_int8(*args)
        ref = int8_block.ln_qkv_reference(*args)
        two = int8_block.i8_gemm_cuda(layernorm.ln_quant_cuda(x, ln, a, 1e-6),
                                      wq["qT"], wq["scale"], bias, a,
                                      int8_block.GEMM_BF16)
        again = all(torch.equal(int8_block.ln_qkv_int8(*args), got)
                    for _ in range(3))
        splits = lib.tpudf_ln_qkv_splits(m, n)
        codes = quant_rows(layernorm.ln_rows_f32(x, ln["scale"], ln["bias"],
                                                 1e-6), a)
        k0 = w // 256 * 128                    # a slice mid-way
        hole = codes.clone()
        hole[:, k0:k0 + 128] = 0
        faults = {
            "panel slice left zero": k5_from_codes(hole, wq, bias, a),
            "g dropped": int8_block.ln_qkv_reference(
                x, {"scale": torch.ones_like(ln["scale"]),
                    "bias": ln["bias"]}, wq, bias, a),
            "act scale ignored": k5_from_codes(
                quant_rows(layernorm.ln_rows_f32(
                    x, ln["scale"], ln["bias"], 1e-6),
                    torch.tensor(1.0, device=dev)), wq, bias, a)}
        del hole, codes
        stale, n_stale = k5_stale_panel(ref, m, n, sms)
        if n_stale:
            faults["panel not rebuilt"] = stale
        del stale
        pre = torch.full((m, n), 7.0, dtype=bf, device=dev)
        filled = int8_block.ln_qkv_int8(*args, out=pre)
        t = int8_block.K5_TILE
        c0, c1 = [(u[1], u[2]) for blk in int8_block.k5_units(m, n, sms)
                  for u in blk if u[2] * t == n][0]
        unstored = filled.clone()
        unstored[:, c0 * t:c1 * t] = 7.0
        faults["one run's columns not stored"] = unstored
        torch.cuda.synchronize()
        ne = not_equal_share(got, two)
        print(f"  K5 {(m, w, n)}: splits {splits} (k5_splits "
              f"{int8_block.k5_splits(m, n, sms)}), stages "
              f"{int8_block.k5_stages(w)}, not bit-equal to K8 + int8 GEMM "
              f"{ne:.3e}, repeated launches equal {again} [{card}]",
              flush=True)
        if splits != int8_block.k5_splits(m, n, sms) or not again or ne:
            raise AssertionError(f"K5 {(m, w, n)}: split, repeat or two-launch"
                                 f" form")
        check_close(f"K5 {(m, w, n)}", got, ref, atol=5e-2, rtol=2e-2)
        held_check(f"K5 {(m, w, n)} |Δ| / (5e-2 + 2e-2 |twin|)", k5_rel, 1.0,
                   filled, ref, faults, card)
        del x, got, ref, two, filled, unstored, pre, faults
        torch.cuda.empty_cache()

    # ---- 9b's wgmma pass: codes, checks and faults planted in the scratch
    for b, s, heads, hd, scale in K9B_SHAPES:
        qkv = sharp_qkv(randn, b, s, heads, hd, hd)
        sd = scale if scale is not None else hd ** -0.5
        qb = min(attention.INT8_Q_BLOCK, s)
        sp = attention.i8_pad(s)
        codes = attention.i8dyn_prepass(qkv, heads, hd, qb)
        plain = attention.attention_i8_codes_reference(qkv, heads, hd)
        same = [bool(torch.equal(x_, y_)) for x_, y_ in zip(codes, plain)]
        got = attention.i8dyn_main(codes, b, s, heads, hd, qb, sd)
        whole = attention.attention_qkv_int8(qkv, heads, hd, scale)
        ref = attention.attention_qkv_int8_reference(qkv, heads, hd, scale)
        amax, q8, k8, v8t = codes
        pos = torch.tensor([attention.vt_pos(x_) for x_ in range(sp)],
                           device=dev)
        k = qkv.float().reshape(b, s, 3, heads, hd)[:, :, 1].transpose(1, 2)
        kt = torch.nn.functional.pad(k, (0, 0, 0, sp - s)).reshape(
            b, heads, sp // 64, 64, hd)
        ak = kt.abs().amax(dim=(-2, -1), keepdim=True) + 1e-6
        k8t = torch.clamp(torch.round(kt * (127.0 / ak)), -127, 127).to(
            torch.int8).reshape(b, heads, sp, hd).contiguous()
        faults = {
            "v8t in natural key order": attention.i8dyn_main(
                (amax, q8, k8, v8t[..., pos].contiguous()), b, s, heads, hd,
                qb, sd),
            "ak over 64-key tiles": attention.i8dyn_main(
                (amax, q8, k8t, v8t), b, s, heads, hd, qb, sd)}
        if s % 64:
            k8p, v8p = k8.clone(), v8t.clone()
            k8p[:, :, s:] = 77
            v8p[..., pos[s:]] = 77
            faults["codes past S"] = attention.i8dyn_main(
                (amax, q8, k8p, v8p), b, s, heads, hd, qb, sd)
            del k8p, v8p
        torch.cuda.synchronize()
        print(f"  9b {(b, s, heads, hd)}: pre-pass codes equal to their plain"
              f" version {same}, wrapper = pre-pass + main pass "
              f"{bool(torch.equal(whole, got))} [{card}]", flush=True)
        if not all(same) or not torch.equal(whole, got):
            raise AssertionError(f"9b {(b, s, heads, hd)}: pre-pass codes")
        held_check(f"9b {(b, s, 3 * heads * hd)} d={hd}, share > 1 bf16 "
                   f"step", share_apart, ATTN_SHARE, got, ref, faults, card)
        del qkv, codes, plain, got, whole, ref, faults, k, kt, k8t
        torch.cuda.empty_cache()

    # ---- K5 alone at the paths' shapes
    for path, m, w, n in K5_TIMED:
        x, ln, wq, bias, a = k5_inputs(m, w, n)
        g16, b16 = ln["scale"].to(bf), ln["bias"].to(bf)
        y16 = F.layer_norm(x, (w,), g16, b16, 1e-6)
        inv = 127.0 / a
        codes = torch.randint(-127, 128, (m, w), generator=g, device=dev,
                              dtype=torch.int8)
        kern = lambda: int8_block.ln_qkv_int8(x, ln, wq, bias, a)
        two = lambda: int8_block.i8_gemm_cuda(
            layernorm.ln_quant_cuda(x, ln, a, 1e-6), wq["qT"], wq["scale"],
            bias, a, int8_block.GEMM_BF16)
        parts = {"F.layer_norm": lambda: F.layer_norm(x, (w,), g16, b16,
                                                      1e-6),
                 "quant": lambda: torch.clamp(torch.round(
                     y16.float() * inv), -127, 127).to(torch.int8),
                 "torch._int_mm": lambda: torch._int_mm(codes,
                                                        wq["qT"].t())}
        ms, two_ms = device_ms(kern), device_ms(two)
        part_ms = {k_: device_ms(f) for k_, f in parts.items()}
        b_ms, b_by = bound({"int8": 2 * m * w * n},
                           nbytes(x, ln["scale"], ln["bias"], wq["q"],
                                  wq["scale"], bias, a) + m * n * 2)
        print(f"  K5 {path} ({m}, {w} -> {n}): device {ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}, {b_ms / ms:.2f} of it); K8 + int8 "
              f"GEMM {two_ms:.4f} ms ({ms / two_ms:.2f}x); PyTorch parts "
              + ", ".join(f"{k_} {v:.4f}" for k_, v in part_ms.items())
              + f" = {sum(part_ms.values()):.4f} ms [{card}]", flush=True)
        rec.rows["K5"].setdefault("launch_alone", []).append(
            {"path": path, "shape": (m, w, n), "device_ms": ms,
             "bound_ms": b_ms, "bound_by": b_by, "two_launch_ms": two_ms,
             "library_parts_ms": part_ms})
        del x, y16, codes
        torch.cuda.empty_cache()

    # ---- 9b's two launches alone at the reference route's shapes
    for path, b, s, heads, hd, scale in K9B_TIMED:
        qkv = sharp_qkv(randn, b, s, heads, hd, hd)
        sd = scale if scale is not None else hd ** -0.5
        qb = min(attention.INT8_Q_BLOCK, s)
        codes = attention.i8dyn_prepass(qkv, heads, hd, qb)
        pre_ms = device_ms(lambda: attention.i8dyn_prepass(qkv, heads, hd,
                                                           qb))
        main_ms = device_ms(lambda: attention.i8dyn_main(codes, b, s, heads,
                                                         hd, qb, sd))
        k9_ms = device_ms(lambda: attention.attention_qkv(qkv, heads, hd,
                                                          scale))
        wa = heads * hd
        qs = [qkv[..., i * wa:(i + 1) * wa].reshape(b, s, heads, hd)
              .transpose(1, 2) for i in range(3)]
        sdpa_ms = device_ms(lambda: F.scaled_dot_product_attention(
            *qs, scale=sd))
        scratch = sum(nbytes(t_) for t_ in codes)
        b_ms, b_by = bound({"int8": 4 * b * heads * s * s * hd},
                           nbytes(qkv) + b * s * wa * 2)
        ms = pre_ms + main_ms
        print(f"  9b {path} ({b}, {s}, {3 * wa}) d={hd}: pre-pass "
              f"{pre_ms:.4f} ms + main pass {main_ms:.4f} ms = {ms:.4f} ms "
              f"device; bound {b_ms:.4f} ms ({b_by}, {b_ms / ms:.2f} of it); "
              f"K9 {k9_ms:.4f} ms ({ms / k9_ms:.2f}x); SDPA bf16 (nearest "
              f"one call) {sdpa_ms:.4f} ms; scratch {scratch / 2 ** 20:.1f} "
              f"MiB [{card}]", flush=True)
        rec.rows["K9b"].setdefault("launch_alone", []).append(
            {"path": path, "shape": (b, s, 3 * wa), "head_dim": hd,
             "prepass_ms": pre_ms, "main_ms": main_ms, "device_ms": ms,
             "bound_ms": b_ms, "bound_by": b_by, "k9_ms": k9_ms,
             "sdpa_ms": sdpa_ms, "scratch_bytes": scratch})
        del qkv, codes, qs
        torch.cuda.empty_cache()


# K6 and K7 on wgmma + TMA (phase 2l, `k6_k7_checks`). K6 at the detect
# cores' B = 8 shapes without a bias, at B = 256 and at phase 2h's head
# widths (S 576 / 584): (B, S, heads, head_dim), W = Wa = heads head_dim;
# K7 at (B, S) of base-256's layer (W 768, MLP 3072). K6_TIMED / K7_TIMED:
# the launches timed alone
K6_SHAPES = [(8, 256, 12, 64), (8, 576, 16, 64), (256, 32, 12, 64),
             (8, 576, 48, 16), (8, 584, 24, 32), (8, 576, 6, 128),
             (8, 584, 3, 256)]
K6_TIMED = [(8, 256, 12, 64), (8, 576, 16, 64)]
K7_SHAPES = [(8, 256), (256, 32)]


def k6_split(qkv, x, wq, bias, a, heads, hd, scale=None):
    """K6's yardstick, two launches: K1's attention launch (its int8 codes
    of the f32 o), then the int8 GEMM in GEMM_RESIDUAL mode."""
    from tpudf_torch.ops import int8_block
    from tpudf_torch.ops.quant import transposed
    b, s, w = x.shape
    o8 = int8_block.attention_i8(qkv, heads, hd, a, scale)
    return k6_proj(o8, x, wq, bias, a)


def k6_proj(o8, x, wq, bias, a):
    """The int8 GEMM's GEMM_RESIDUAL epilogue on codes o8 (B S, Wa)."""
    from tpudf_torch.ops import int8_block
    from tpudf_torch.ops.quant import transposed
    b, s, w = x.shape
    return int8_block.i8_gemm_cuda(
        o8.contiguous(), transposed(wq), wq["scale"], bias, a,
        int8_block.GEMM_RESIDUAL,
        residual=x.reshape(b * s, w).contiguous()).reshape(b, s, w)


def unswizzled(o8, s):
    """K6's codes as wgmma would read a panel written without the 128-byte
    swizzle: in each 128-column slice, row r's 16-byte chunk c taken from
    chunk c ^ (r % 8) (r the row in its 128-row tile)."""
    import torch
    m, wa = o8.shape
    rows = torch.arange(m, device=o8.device) % s % 8
    idx = torch.arange(8, device=o8.device)[None, :] ^ rows[:, None]
    v = o8.reshape(m, wa // 128, 8, 16)
    idx = idx[:, None, :, None].expand(m, wa // 128, 8, 16)
    return torch.gather(v, 2, idx).reshape(m, wa)


def k7_twin(x, bp, heads, hd, fault=None, q8=None):
    """`siglip_layer_int8_reference`'s math, with LN1's codes q8 where
    given (K8's, which K5 and K7's first phase equal bit for bit), and
    with a planted fault: "x1 in bf16" (the mid-layer residual rounded
    between the phases), "LN2 over x" (in place of x1), "GELU dropped",
    "early start" (the first 128-row tile's LN2 read from the x1 workspace
    before its rows are written: zeros)."""
    import torch
    from tpudf_torch.ops import attention
    from tpudf_torch.ops.layernorm import ln_rows_f32
    from tpudf_torch.ops.quant import f32_scalar, int8_mm, quant_rows
    from tpudf_torch.utils.nn import gelu_tanh
    b, s, w = x.shape
    at, ml, sc = bp["attn"], bp["mlp"], bp["act_scales"]
    aq, ao, a1, a2 = (f32_scalar(sc[k], x.device)
                      for k in ("qkv", "out", "fc1", "fc2"))

    def deq(acc, a, wq):
        return acc.float() * ((a / 127.0) * wq["scale"].float())

    x32 = x.float().reshape(b * s, w)
    if q8 is None:
        q8 = quant_rows(ln_rows_f32(x32, bp["ln1"]["scale"],
                                    bp["ln1"]["bias"], 1e-6), aq)
    qkv = (deq(int8_mm(q8, at["qkv_w"]["q"]), aq, at["qkv_w"])
           + at["qkv_b"].float()).to(torch.bfloat16).reshape(b, s, 3 * w)
    o = attention.attention_qkv_reference(qkv, heads, hd, hd ** -0.5,
                                          out_dtype=torch.float32)
    o8 = quant_rows(o.reshape(b * s, w), ao)
    x1 = (x32 + deq(int8_mm(o8, at["out_w"]["q"]), ao, at["out_w"])
          + at["out_b"].float())
    if fault == "x1 in bf16":
        x1 = x1.to(torch.bfloat16).float()
    ln_in = x32 if fault == "LN2 over x" else x1
    if fault == "early start":
        ln_in = ln_in.clone()
        ln_in[:128] = 0.0
    q1 = quant_rows(ln_rows_f32(ln_in, bp["ln2"]["scale"], bp["ln2"]["bias"],
                                1e-6), a1)
    f1 = deq(int8_mm(q1, ml["fc1_w"]["q"]), a1, ml["fc1_w"]) + ml["fc1_b"]
    q2 = quant_rows(f1 if fault == "GELU dropped" else gelu_tanh(f1), a2)
    out = deq(int8_mm(q2, ml["fc2_w"]["q"]), a2, ml["fc2_w"]) + ml["fc2_b"]
    return (x1 + out).to(x.dtype).reshape(b, s, w)


def k7_rule(got, ref):
    """(elements outside atol 5e-2 + rtol 2e-2, share not bit-equal): K7's
    card rule holds where both are within bounds (0, K7_SHARE)."""
    err = (got.float() - ref.float()).abs()
    return (int((err > 5e-2 + 2e-2 * ref.float().abs()).sum()),
            float((got != ref).float().mean()))


def k6_k7_checks(rec, dev, card):
    """Phase 2l. K6 at K6_SHAPES, one launch each (its cluster size and
    shared memory equal to `int8_block.k6_cluster` / `k6_smem`): against
    its twin by phase 2b's rule (atol 5e-2 + rtol 2e-2, and the error
    within ATTN_REL of what the sublayer adds to x), bit-equal to its split
    form (K1's attention launch + the int8 GEMM in GEMM_RESIDUAL mode) and
    to itself over repeated launches; each shape's check shown to fail on
    planted faults: one CTA's heads never received into the panels (their
    codes zero), the panel written without the swizzle, one 128-column
    weight tile skipped (its outputs zero), the bias dropped, the residual
    dropped, the scale x0.75, and at a ragged S the keys past S unmasked.
    K7 at K7_SHAPES by its card rule (K1's elements and at most K7_SHARE of
    the outputs not bit-equal) against the twin on K8's LN1 codes (those of
    its first phase; the plain twin holds the element tolerance, its share
    printed), bit-equal over repeated launches, shown to fail with the
    mid-layer residual x1 in bf16, LN2 over x, GELU dropped and an
    emulated early start of a phase-3 row tile.
    Then each launch alone by device time: K6 at K6_TIMED beside its split
    form, its bound and SDPA + the out-projection's `_int_mm`; K7 at (8,
    256, 768) beside the FPP layer (K1's four launches and K2's three) and
    its bound; into K6's and K7's rows."""
    import torch
    import torch.nn.functional as F
    from tpudf_torch.convert import add_kernel_layout
    from tpudf_torch.core.backend import LAUNCHES
    from tpudf_torch.ops import _build, int8_block, layernorm, mlp, quant
    from tpudf_torch.ops.quant import quantize_weight
    print("phase 2l: K6 (cluster tile on wgmma + TMA) and K7 (four phases on "
          "the sm90 tiles)", flush=True)
    lib = _build.load()
    g = torch.Generator(device=dev).manual_seed(71)
    bf = torch.bfloat16

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=g, device=dev) * std

    def wq_of(k, n):
        return add_kernel_layout(quantize_weight(randn(k, n, std=k ** -0.5)))

    timed = {}
    for b, s, heads, hd in K6_SHAPES:
        wa = w = heads * hd
        tile, live = int8_block.k6_tile(hd)
        waves = {n: lib.tpudf_attn_out_waves(tile, wa, n)
                 for n in range(1, 9)}
        c = int8_block.k6_cluster(b, s, heads, tile, live, w, waves)
        c_lib = lib.tpudf_attn_out_cluster(b, s, heads, tile, live, w)
        smem = lib.tpudf_attn_out_smem(tile, wa)
        if c != c_lib or smem != int8_block.k6_smem(tile, wa):
            raise AssertionError(f"K6 {(b, s, heads, hd)}: cluster {c_lib} / "
                                 f"smem {smem} on the card, {c} / "
                                 f"{int8_block.k6_smem(tile, wa)} in Python")
        qkv = sharp_qkv(randn, b, s, heads, hd, hd)
        x = randn(b, s, w).to(bf)
        wq, bias = wq_of(wa, w), randn(w, std=0.1)
        a = torch.tensor(2.0, device=dev)
        args = (qkv, x, wq, bias, a, heads, hd)
        LAUNCHES.reset()
        got = int8_block.attn_out_int8(*args)
        torch.cuda.synchronize()
        check_launches(f"K6 {(b, s, 3 * wa)}", LAUNCHES.snapshot(),
                       {int8_block.KERNEL_ATTN_OUT: 1})
        again = int8_block.attn_out_int8(*args)
        split = k6_split(*args)
        ref = int8_block.attn_out_reference(*args)
        torch.cuda.synchronize()
        label = (f"K6 {(b, s, 3 * wa)} heads of {hd} (cluster {c} of "
                 f"{waves[c]} at a time)")
        if not torch.equal(got, split) or not torch.equal(got, again):
            raise AssertionError(f"{label}: not bit-equal to its split form "
                                 f"({int((got != split).sum())} outputs) or "
                                 f"to itself over launches")
        check_close(label, got, ref, atol=5e-2, rtol=2e-2)
        o8 = int8_block.attention_i8(qkv, heads, hd, a)
        lost = o8.clone().reshape(b * s, heads, hd)
        lost[:, 1 % c::c] = 0
        skipped = split.clone()
        skipped[..., 128:256] = 0
        faults = {
            "a CTA's heads not received": k6_proj(lost.reshape(b * s, wa), x,
                                                  wq, bias, a),
            "panel unswizzled": k6_proj(unswizzled(o8, s), x, wq, bias, a),
            "a weight tile skipped": skipped,
            "bias dropped": k6_proj(o8, x, wq, torch.zeros_like(bias), a),
            "residual dropped": k6_proj(o8, torch.zeros_like(x), wq, bias,
                                        a),
            "scale x0.75": k6_split(*args, scale=0.75 * hd ** -0.5)}
        if s % 64:
            faults["keys past S unmasked"] = keys_unmasked(
                lambda q: k6_split(q, torch.cat(
                    [x, x[:, -1:].expand(b, -s % 64, -1)], 1), wq, bias, a,
                    heads, hd), qkv)
        held_check(f"{label} vs twin, of the attention part", rel_part(x),
                   ATTN_REL, got, ref, faults, card)
        print(f"  {label}: bit-equal to K1's attention + the int8 GEMM and "
              f"over launches; max|Δ| vs twin {max_abs(got, ref):.3e} "
              f"[{card}]", flush=True)
        if (b, s, heads, hd) in K6_TIMED:
            timed[(b, s, heads, hd)] = (args, o8)
        del qkv, x, got, again, split, ref, o8, lost, skipped, faults

    # ---- K7
    w, heads, hd, inter = 768, 12, 64, 3072
    bp = {"ln1": {"scale": 1.0 + randn(w, std=0.1), "bias": randn(w, std=0.1)},
          "ln2": {"scale": 1.0 + randn(w, std=0.1), "bias": randn(w, std=0.1)},
          "attn": {"qkv_w": wq_of(w, 3 * w), "qkv_b": randn(3 * w, std=0.1),
                   "out_w": wq_of(w, w), "out_b": randn(w, std=0.1)},
          "mlp": {"fc1_w": wq_of(w, inter), "fc1_b": randn(inter, std=0.1),
                  "fc2_w": wq_of(inter, w), "fc2_b": randn(w, std=0.1)},
          "act_scales": {k: torch.tensor(v, device=dev) for k, v in
                         (("qkv", 4.0), ("out", 2.0), ("fc1", 4.0),
                          ("fc2", 3.0))}}
    for b, s in K7_SHAPES:
        waves = {n: lib.tpudf_attn_out_waves(64, w, n) for n in range(1, 9)}
        c, blocks, _, _ = int8_block.k7_launch(b, s, heads, w, inter, waves)
        if lib.tpudf_layer_cluster(b, s, heads, w, 64, 64) != c:
            raise AssertionError(f"K7 {(b, s, w)}: cluster "
                                 f"{lib.tpudf_layer_cluster(b, s, heads, w, 64, 64)}"
                                 f" on the card, {c} in Python")
        x = randn(b, s, w).to(bf)
        LAUNCHES.reset()
        got = int8_block.siglip_layer_int8(x, bp, heads, hd)
        torch.cuda.synchronize()
        check_launches(f"K7 {(b, s, w)}", LAUNCHES.snapshot(),
                       {int8_block.KERNEL_LAYER: 1})
        again = int8_block.siglip_layer_int8(x, bp, heads, hd)
        twin = int8_block.siglip_layer_int8_reference(x, bp, heads, hd)
        if not torch.equal(k7_twin(x, bp, heads, hd), twin):
            raise AssertionError("K7's fault twin is not the twin")
        # the twin on K8's LN1 codes (K5's, K7's phase 1): one LN1 code at
        # a tie of the f32 statistics moves ~1e-1 of the layer's outputs
        # off the twin's bits, in this kernel and in its mma.sync
        # predecessor alike (PERF.md, PR 15)
        q8 = layernorm.layer_norm_quant(x.reshape(-1, w), bp["ln1"]["scale"],
                                        bp["ln1"]["bias"],
                                        bp["act_scales"]["qkv"])
        ref = k7_twin(x, bp, heads, hd, q8=q8)
        torch.cuda.synchronize()
        out_tol, share = k7_rule(got, ref)
        twin_tol, twin_share = k7_rule(got, twin)
        ln1_flips = float((q8 != quant.quant_rows(
            layernorm.ln_rows_f32(x.float().reshape(-1, w),
                                  bp["ln1"]["scale"], bp["ln1"]["bias"],
                                  1e-6), bp["act_scales"]["qkv"])).any(
                                      -1).float().mean())
        bad = {f: k7_rule(k7_twin(x, bp, heads, hd, f, q8), ref)
               for f in ("x1 in bf16", "LN2 over x", "GELU dropped",
                         "early start")}
        print(f"  K7 {(b, s, w)} (clusters of {c}, {blocks} blocks) vs the "
              f"twin on K8's LN1 codes: outside the "
              f"element tolerance {out_tol}, not bit-equal {share:.3e} "
              f"(limit {K7_SHARE:g}), max|Δ| {max_abs(got, ref):.3e} (vs "
              f"the twin: {twin_tol} outside, {twin_share:.3e} not "
              f"bit-equal; rows with an LN1 code at a tie {ln1_flips:.3e}); "
              f"planted faults "
              + ", ".join(f"{k} {n} / {sh:.3e}" for k, (n, sh) in bad.items())
              + f" [{card}]", flush=True)
        if twin_tol:
            raise AssertionError(f"K7 {(b, s, w)}: {twin_tol} outputs outside "
                                 f"the twin's element tolerance")
        if not torch.equal(got, again):
            raise AssertionError(f"K7 {(b, s, w)}: not bit-equal over "
                                 f"launches")
        if out_tol or share > K7_SHARE:
            raise AssertionError(f"K7 {(b, s, w)}: {out_tol} outputs outside "
                                 f"the tolerance, {share:.3e} not bit-equal")
        missed = [k for k, (n, sh) in bad.items()
                  if n == 0 and sh <= K7_SHARE]
        if missed:
            raise AssertionError(f"K7's checks miss {missed}")
        del got, again, ref, twin, q8

    # ---- each launch alone, device time
    for (b, s, nh, dh), (args, o8) in timed.items():
        qkv, x, wq, bias, a = args[:5]
        wa = w_ = nh * dh
        q, k, v = (qkv[..., i * wa:(i + 1) * wa].reshape(b, s, nh, dh)
                   .transpose(1, 2) for i in range(3))
        k6 = device_ms(lambda: int8_block.attn_out_int8(*args))
        att = device_ms(lambda: int8_block.attention_i8(qkv, nh, dh, a))
        proj = device_ms(lambda: k6_proj(o8, x, wq, bias, a))
        sdpa = device_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        mm = device_ms(lambda: torch._int_mm(o8, wq["qT"].t()))
        b_ms, b_by = bound({"bf16": 4 * b * nh * s * s * dh,
                            "int8": 2 * b * s * wa * w_},
                           nbytes(qkv, x, wq["q"], wq["scale"], bias, a)
                           + nbytes(x))
        rec.rows.get("K6", {}).setdefault("phase_2l", []).append(
            {"shape": (b, s, 3 * wa, w_), "device_ms": k6,
             "split_device_ms": att + proj, "bound_ms": b_ms,
             "bound_by": b_by, "library_part_ms": {"SDPA": sdpa,
                                                   "out-proj _int_mm": mm}})
        print(f"  K6 {(b, s, 3 * wa)} alone, device: {k6:.4f} ms; split form "
              f"{att + proj:.4f} (K1's attention {att:.4f} + the int8 GEMM "
              f"{proj:.4f}; K6 {k6 / (att + proj):.2f}x); bound {b_ms:.4f} "
              f"({b_by}); SDPA {sdpa:.4f} + out-proj _int_mm {mm:.4f} "
              f"[{card}]", flush=True)
    b, s = 8, 256
    x = randn(b, s, w).to(bf)
    sc = bp["act_scales"]
    at = bp["attn"]

    def fpp():
        x1 = int8_block.attn_sublayer_int8(
            x, bp["ln1"], at["qkv_w"], at["qkv_b"], at["out_w"], at["out_b"],
            sc["qkv"], sc["out"], heads, hd)
        return mlp.mlp_block_fused_int8(x1, bp["ln2"], bp["mlp"],
                                        {"fc1": sc["fc1"], "fc2": sc["fc2"]})

    k7 = device_ms(lambda: int8_block.siglip_layer_int8(x, bp, heads, hd))
    fpp_ms = device_ms(fpp)
    m = b * s
    b_ms, b_by = bound({"int8": 2 * m * w * (4 * w + 2 * inter),
                        "bf16": 4 * b * heads * s * s * hd},
                       nbytes(x, *[t for d in (bp["ln1"], bp["ln2"])
                                   for t in d.values()],
                              *[t for wq in (at["qkv_w"], at["out_w"],
                                             bp["mlp"]["fc1_w"],
                                             bp["mlp"]["fc2_w"])
                                for t in (wq["q"], wq["scale"])],
                              at["qkv_b"], at["out_b"], bp["mlp"]["fc1_b"],
                              bp["mlp"]["fc2_b"], *sc.values()) + nbytes(x))
    rec.rows.get("K7", {}).setdefault("phase_2l", []).append(
        {"shape": (b, s, w), "device_ms": k7, "fpp_device_ms": fpp_ms,
         "bound_ms": b_ms, "bound_by": b_by})
    print(f"  K7 {(b, s, w)} alone, device: {k7:.4f} ms; the FPP layer (K1's "
          f"four launches + K2's three) {fpp_ms:.4f} (K7 {k7 / fpp_ms:.2f}x); "
          f"bound {b_ms:.4f} ({b_by}) [{card}]", flush=True)
    torch.cuda.empty_cache()


# ROADMAP Queue C 1-3 (phase 2m, `queue_c_checks`). K6 where JAX's fit
# holds past its panel (K6_MAX_WA): (B, S, heads, head_dim, W); K7 at the
# geometries JAX's whole-layer kernel takes that the one-launch kernel did
# not before (heads of 8 to 256, S 576), then those its split form runs
# (a wide head, Wa past K6's panel, W past the LN panel): (B, S, W, heads,
# head_dim, MLP); the row pass past 1280: (rows, W); K5 past its panel:
# (M, W); K8 re-timed alone: (rows, W); the queue's path: base-256's
# layer at S = 64 (a 128 px image) under LLL, one block at W 1408 (22
# heads of 64, MLP 128, 2 images of 64 tokens) under LLL and PPP
QC_K6 = [(2, 256, 18, 64, 1152), (2, 256, 8, 128, 1024),
         (2, 256, 4, 256, 1024), (2, 576, 8, 128, 1024)]
QC_K7 = [(2, 64, 256, 2, 128, 512), (2, 64, 128, 8, 16, 256),
         (2, 64, 128, 4, 32, 256), (2, 576, 128, 2, 64, 256),
         (2, 64, 128, 16, 8, 256), (2, 64, 512, 2, 256, 512),
         (2, 64, 384, 1, 384, 512), (2, 64, 1152, 18, 64, 256),
         (2, 64, 1408, 22, 64, 128)]
QC_LN = [(8192, 1408), (8192, 1536), (4096, 4096)]
QC_K5 = [(2048, 1408), (2048, 1536)]
K8_TIMED = [(2048, 768), (8192, 1152)]
QC_BLOCK = (2, 64, 1408, 22, 64, 128)
QC_BASE = (8, 64, 768, 12, 64, 3072)      # base-256's layer at 128 px
# K3 alone (phase 2m, `k3_checks`): the batches of its paths (B = 8
# forwards; the detect cores at B = 64, 128, 256) of 256 x 256 images
K3_BATCHES = (8, 64, 128, 256)


def fails_by(got, fault, atol, rtol):
    """How many times its tolerance a planted fault's output is off."""
    err = (got.float() - fault.float()).abs()
    return float((err / (atol + rtol * fault.float().abs())).max())


def k7_tree(randn, wq_of, w, inter, dev):
    """A seeded static-W8A8 layer (`siglip_layer_int8`'s tree) of width w
    and MLP inter."""
    import torch
    return {"ln1": {"scale": 1.0 + randn(w, std=0.1),
                    "bias": randn(w, std=0.1)},
            "ln2": {"scale": 1.0 + randn(w, std=0.1),
                    "bias": randn(w, std=0.1)},
            "attn": {"qkv_w": wq_of(w, 3 * w), "qkv_b": randn(3 * w, std=0.1),
                     "out_w": wq_of(w, w), "out_b": randn(w, std=0.1)},
            "mlp": {"fc1_w": wq_of(w, inter), "fc1_b": randn(inter, std=0.1),
                    "fc2_w": wq_of(inter, w), "fc2_b": randn(w, std=0.1)},
            "act_scales": {k: torch.tensor(v, device=dev)
                           for k, v in (("qkv", 4.0), ("out", 2.0),
                                        ("fc1", 4.0), ("fc2", 3.0))}}


def ln_half_stats(x, g, b):
    """The LN with its statistics over the first half of each row: the
    wide row's second half dropped from the sums."""
    import torch
    x32 = x.float()
    h = x32[..., :x32.shape[-1] // 2]
    mu = h.mean(-1, keepdim=True)
    var = torch.clamp((h * h).mean(-1, keepdim=True) - mu * mu, min=0.0)
    return (x32 - mu) * torch.rsqrt(var + 1e-6) * g.float() + b.float()


def queue_c_checks(rec, dev, card):
    """Phase 2m, ROADMAP Queue C 1-3. (1a) K6 at QC_K6, where JAX runs its
    kernel past K6_MAX_WA: the split route (KERNEL_ATTN_OUT_SPLIT, one
    launch count), bit-equal to K1's attention launch + the int8 GEMM, by
    phase 2b's rule against the twin; planted faults: the route skipped
    (the residual alone), the scale x0.75. (1b) K7 at QC_K7, each by the
    form `k7_form` names (one launch or the split form, one count each):
    phase 2l's rule against the twin on K8's LN1 codes, the plain twin's
    element tolerance, bit-equal over launches; planted faults x1 in bf16,
    LN2 over x, GELU dropped. (1c) K4, K8 and the f32 row pass at QC_LN
    (K4 one bf16 step; codes at most K8_SHARE apart, by one; fault: the
    row's second half dropped from the statistics), K5 past its panel at
    QC_K5 (K8 + the int8 GEMM, bit-equal, phase 2b's rule), K1 and K2 at W
    1408. Every planted fault must fail by at least twice its tolerance.
    Then K8 alone at K8_TIMED and the row pass at QC_LN (device times into
    K8's and K4's rows), and the queue's path (QC_BLOCK under LLL and PPP,
    counts set to 0 just before each): the launches of the split forms'
    rows, each timed beside its twin. Returns those launches."""
    import os as _os
    import torch
    import torch.nn.functional as F
    from tpudf_torch.convert import add_kernel_layout
    from tpudf_torch.core.backend import LAUNCHES
    from tpudf_torch.models.siglip import SigLIPConfig, _block_apply
    from tpudf_torch.ops import _build, int8_block, layernorm, mlp, quant
    from tpudf_torch.ops.quant import quantize_weight, transposed
    from tpudf_torch.ops.routes import TWINS
    print("phase 2m: Queue C (K6 past its panel, K7 on JAX's decision, rows "
          "past 1280)", flush=True)
    lib = _build.load()
    g = torch.Generator(device=dev).manual_seed(83)
    bf = torch.bfloat16

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=g, device=dev) * std

    def wq_of(k, n):
        return add_kernel_layout(quantize_weight(randn(k, n, std=k ** -0.5)))

    def twice(label, factors):
        print(f"  {label}: planted faults fail by "
              + ", ".join(f"{k} {v:.3g}x" for k, v in factors.items())
              + f" their tolerance [{card}]", flush=True)
        missed = [k for k, v in factors.items() if v < 2.0]
        if missed:
            raise AssertionError(f"{label}: faults under 2x: {missed}")

    # ---- 1a: K6 past its panel
    for b, s, heads, hd, w in QC_K6:
        wa = heads * hd
        if int8_block.k6_route(s, heads, hd, w) != "split":
            raise AssertionError(f"K6 {(b, s, wa, w)}: not the split route")
        qkv = sharp_qkv(randn, b, s, heads, hd, hd)
        x = randn(b, s, w).to(bf)
        wq, bias = wq_of(wa, w), randn(w, std=0.1)
        a = torch.tensor(2.0, device=dev)
        args = (qkv, x, wq, bias, a, heads, hd)
        LAUNCHES.reset()
        got = int8_block.attn_out_int8(*args)
        torch.cuda.synchronize()
        check_launches(f"K6 past its panel {(b, s, 3 * wa)}",
                       LAUNCHES.snapshot(),
                       {int8_block.KERNEL_ATTN_OUT_SPLIT: 1})
        split = k6_split(*args)
        ref = int8_block.attn_out_reference(*args)
        torch.cuda.synchronize()
        label = f"K6 {(b, s, 3 * wa)} heads of {hd}, W {w} (split route)"
        if not torch.equal(got, split):
            raise AssertionError(f"{label}: not bit-equal to the split form")
        check_close(label, got, ref, atol=5e-2, rtol=2e-2)
        measure = rel_part(x)
        sound = measure(got, ref)
        if sound > ATTN_REL:
            raise AssertionError(f"{label}: {sound:.3e} > {ATTN_REL}")
        print(f"  {label}: bit-equal to K1's attention + the int8 GEMM; "
              f"{sound:.3e} of the attention part (limit {ATTN_REL:g}) "
              f"[{card}]", flush=True)
        twice(label, {
            "route skipped": measure(x, ref) / ATTN_REL,
            "scale x0.75": measure(k6_split(*args, scale=0.75 * hd ** -0.5),
                                   ref) / ATTN_REL})
        del qkv, x, got, split, ref

    # ---- 1b: K7 on JAX's decision
    for b, s, w, heads, hd, inter in QC_K7:
        bp = k7_tree(randn, wq_of, w, inter, dev)
        x = randn(b, s, w).to(bf)
        if not int8_block.layer_int8_eligible(x, bp, heads, hd):
            raise AssertionError(f"K7 {(b, s, w)}: JAX's K7 takes it")
        form = int8_block.k7_form(s, w, heads, hd)
        name = (int8_block.KERNEL_LAYER if form == "one"
                else int8_block.KERNEL_LAYER_SPLIT)
        LAUNCHES.reset()
        got = int8_block.siglip_layer_int8(x, bp, heads, hd)
        torch.cuda.synchronize()
        label = f"K7 {(b, s, w)} {heads} heads of {hd} MLP {inter} ({form})"
        check_launches(label, LAUNCHES.snapshot(), {name: 1})
        again = int8_block.siglip_layer_int8(x, bp, heads, hd)
        twin = int8_block.siglip_layer_int8_reference(x, bp, heads, hd)
        q8 = layernorm.layer_norm_quant(x.reshape(-1, w), bp["ln1"]["scale"],
                                        bp["ln1"]["bias"],
                                        bp["act_scales"]["qkv"])
        ref = k7_twin(x, bp, heads, hd, q8=q8)
        torch.cuda.synchronize()
        out_tol, share = k7_rule(got, ref)
        twin_tol, twin_share = k7_rule(got, twin)
        c = "-"
        if form == "one":
            tile, live = int8_block.k6_tile(hd)
            c = lib.tpudf_layer_cluster(b, s, heads, w, tile, live)
            smem = lib.tpudf_layer_smem(w, heads * live, tile)
            if smem != int8_block.k7_smem(w, heads * live, tile):
                raise AssertionError(f"{label}: shared memory {smem} on the "
                                     f"card, {int8_block.k7_smem(w, heads * live, tile)}"
                                     f" in Python")
        print(f"  {label}: vs the twin on K8's LN1 codes outside {out_tol}, "
              f"not bit-equal {share:.3e} (limit {K7_SHARE:g}), max|Δ| "
              f"{max_abs(got, ref):.3e}; vs the twin {twin_tol} outside, "
              f"{twin_share:.3e}; cluster {c} [{card}]", flush=True)
        if twin_tol or out_tol or share > K7_SHARE:
            raise AssertionError(f"{label}: outside phase 2l's rule")
        if not torch.equal(got, again):
            raise AssertionError(f"{label}: not bit-equal over launches")
        factors = {}
        for f in ("x1 in bf16", "LN2 over x", "GELU dropped"):
            bad = k7_twin(x, bp, heads, hd, f, q8)
            factors[f] = max(k7_rule(bad, ref)[1] / K7_SHARE,
                             fails_by(bad, ref, 5e-2, 2e-2))
        twice(label, factors)
        del bp, x, got, again, twin, ref, q8

    # ---- 1c: rows past 1280
    widths = (lib.tpudf_ln_max_width(2), lib.tpudf_ln_max_width(4))
    if widths != (layernorm.MAX_WIDTH, layernorm.MAX_WIDTH_F32):
        raise AssertionError(f"the row pass's widest rows {widths} on the "
                             f"card, {layernorm.MAX_WIDTH} / "
                             f"{layernorm.MAX_WIDTH_F32} in Python")
    for rows, w in QC_LN:
        x = (randn(rows, w) * 3.0 + 0.5).to(bf)
        gm, bt = 1.0 + randn(w, std=0.1), randn(w, std=0.1)
        a = torch.tensor(3.0, device=dev)
        got = layernorm.layer_norm_fused(x, gm, bt)
        ref = layernorm.layer_norm_reference(x, gm, bt)
        codes = layernorm.layer_norm_quant(x, gm, bt, a)
        want = layernorm.layer_norm_quant_reference(x, gm, bt, a)
        x32 = randn(rows, w) * 3.0 + 0.5
        c32 = layernorm.ln_quant_f32_cuda(x32, {"scale": gm, "bias": bt}, a,
                                          1e-6)
        w32 = layernorm.layer_norm_quant_reference(x32, gm, bt, a)
        torch.cuda.synchronize()
        label = f"row pass {(rows, w)}"
        check_close(f"K4 {label}", got, ref, atol=1e-6, rtol=2 ** -7)
        half = ln_half_stats(x, gm, bt)
        shares = {}
        for key, (cg, cw) in {"bf16": (codes, want),
                              "f32": (c32, w32)}.items():
            d = (cg.int() - cw.int()).abs()
            shares[key] = float((d > 0).float().mean())
            if int(d.max()) > 1 or shares[key] > K8_SHARE:
                raise AssertionError(f"K8 {label} ({key}): codes "
                                     f"{shares[key]:.3e} apart, max "
                                     f"{int(d.max())}")
        half_codes = quant.quant_rows(half, a)
        print(f"  {label}: K4 max|Δ| {max_abs(got, ref):.3e}; K8 codes apart "
              f"{shares['bf16']:.3e}, the f32 pass's {shares['f32']:.3e} "
              f"(limit {K8_SHARE:g}) [{card}]", flush=True)
        twice(label, {
            "K4 second half dropped": fails_by(got, half.to(bf), 1e-6,
                                               2 ** -7),
            "K8 second half dropped": float(
                (half_codes != want).float().mean()) / K8_SHARE})
        ms = device_ms(lambda: layernorm.layer_norm_fused(x, gm, bt))
        lib_ms = device_ms(lambda: F.layer_norm(x, (w,), gm.to(bf),
                                                bt.to(bf), 1e-6))
        b_ms, _ = bound({"f32": K4_OPS_PER_ELEMENT * x.numel()},
                        2 * nbytes(x) + nbytes(gm, bt))
        rec.rows["K4"].setdefault("device", []).append(
            {"shape": (rows, w), "params": "f32", "device_ms": ms,
             "bound_ms": b_ms, "bound_by": "bytes", "library_ms": lib_ms})
        print(f"  K4 {label} alone, device: {ms:.4f} ms; bound {b_ms:.4f}; "
              f"F.layer_norm {lib_ms:.4f} [{card}]", flush=True)
        del x, got, ref, codes, want, x32, c32, w32, half, half_codes

    for m, w in QC_K5:
        n = 3 * w
        x = randn(m, w).to(bf)
        ln = {"scale": 1.0 + randn(w, std=0.1), "bias": randn(w, std=0.1)}
        wq, bias = wq_of(w, n), randn(n, std=0.1)
        a = torch.tensor(4.0, device=dev)
        LAUNCHES.reset()
        got = int8_block.ln_qkv_int8(x, ln, wq, bias, a)
        torch.cuda.synchronize()
        check_launches(f"K5 {(m, w, n)}", LAUNCHES.snapshot(),
                       {int8_block.KERNEL_LN_QKV_SPLIT: 1})
        codes = layernorm.layer_norm_quant(x, ln["scale"], ln["bias"], a)
        pair = int8_block.i8_gemm_cuda(codes, transposed(wq), wq["scale"],
                                       bias, a, int8_block.GEMM_BF16)
        ref = int8_block.ln_qkv_reference(x, ln, wq, bias, a)
        torch.cuda.synchronize()
        if not torch.equal(got, pair):
            raise AssertionError(f"K5 {(m, w, n)}: not bit-equal to K8 + "
                                 f"the int8 GEMM")
        check_close(f"K5 {(m, w, n)}", got, ref, atol=5e-2, rtol=2e-2)
        print(f"  K5 past its panel {(m, w, n)}: K8 + the int8 GEMM, "
              f"bit-equal; max|Δ| vs twin {max_abs(got, ref):.3e} "
              f"[{card}]", flush=True)
        if (m, w) == QC_K5[0]:
            rec.add("K5-split", "ln_qkv_int8_split", (m, w, n),
                    max_abs(got, ref),
                    lambda: int8_block.ln_qkv_int8(x, ln, wq, bias, a),
                    lambda: int8_block.ln_qkv_reference(x, ln, wq, bias, a),
                    ({"int8": 2 * m * w * n},
                     nbytes(x, ln["scale"], ln["bias"], wq["q"], wq["scale"],
                            bias, a) + nbytes(got)),
                    library={"part F.layer_norm": lambda: F.layer_norm(
                        x, (w,), ln["scale"].to(bf), ln["bias"].to(bf), 1e-6),
                             "part _int_mm": lambda: torch._int_mm(
                                 codes, wq["qT"].t())},
                    device_time=True)
        del x, got, codes, pair, ref

    # K1 and K2 at W 1408 (the row pass opens both)
    w, heads, hd, inter = 1408, 22, 64, 5632
    lay = w8a8_layer(randn, dev, w, heads, hd, inter)
    x = randn(2, 64, w).to(bf)
    args = (x, lay["ln1"], lay["qkv_wq"], lay["qkv_b"], lay["out_wq"],
            lay["out_b"], lay["a_qkv"], lay["a_out"], heads, hd)
    got = int8_block.attn_sublayer_int8(*args)
    ref = int8_block.attn_sublayer_reference(*args)
    got2 = mlp.mlp_block_fused_int8(x, lay["ln1"], lay["mlp"], lay["sc"])
    ref2 = mlp.mlp_block_int8_reference(x, lay["ln1"], lay["mlp"], lay["sc"])
    torch.cuda.synchronize()
    check_close("K1 (2, 64, 1408)", got, ref, atol=5e-2, rtol=2e-2)
    check_close("K2 (2, 64, 1408)", got2, ref2, atol=5e-2, rtol=2e-2)
    print(f"  K1 / K2 at W 1408: max|Δ| {max_abs(got, ref):.3e} / "
          f"{max_abs(got2, ref2):.3e} [{card}]", flush=True)
    del lay, x, got, ref, got2, ref2

    # ---- K8 alone, re-timed (its row kernel is K4's)
    for rows, w in K8_TIMED:
        x = randn(rows, w).to(bf)
        gm, bt = 1.0 + randn(w, std=0.1), randn(w, std=0.1)
        a = torch.tensor(3.0, device=dev)
        ms = device_ms(lambda: layernorm.layer_norm_quant(x, gm, bt, a))
        lib_ms = device_ms(lambda: F.layer_norm(x, (w,), gm.to(bf),
                                                bt.to(bf), 1e-6))
        b_ms, b_by = bound({"f32": K8_OPS_PER_ELEMENT * x.numel()},
                           nbytes(x, gm, bt, a) + x.numel())
        rec.rows["K8"].setdefault("device", []).append(
            {"shape": (rows, w), "device_ms": ms, "bound_ms": b_ms,
             "bound_by": b_by, "library_part_ms": {"F.layer_norm": lib_ms}})
        print(f"  K8 {(rows, w)} alone, device: {ms:.4f} ms; bound "
              f"{b_ms:.4f} ({b_by}); part F.layer_norm {lib_ms:.4f} "
              f"[{card}]", flush=True)

    # ---- the queue's path: a base-256 block at S = 64 under LLL (the
    # one-launch K7), one block at W 1408 under LLL, then PPP (the split
    # forms)
    launches, old = {}, _os.environ.get("TPUDF_INT8_KERNELS")
    b, s, w, heads, hd, inter = QC_BASE
    bp = k7_tree(randn, wq_of, w, inter, dev)
    cfg = SigLIPConfig(w, 1, heads, inter, 128, 16, with_head=False)
    x = randn(b, s, w).to(bf)
    try:
        _os.environ["TPUDF_INT8_KERNELS"] = "LLL"
        LAUNCHES.reset()
        out = _block_apply(x, bp, cfg)
        torch.cuda.synchronize()
        got = LAUNCHES.snapshot()
        check_launches("the queue's base-256 block LLL", got,
                       {int8_block.KERNEL_LAYER: 1})
        launches.update(got)
        twin = _block_apply(x, bp, cfg, kernels=TWINS)
        print(f"  the queue's block {(b, s, w)} LLL: launches {got}; "
              f"max|Δ| vs twins {max_abs(out, twin):.3e} [{card}]",
              flush=True)
    finally:
        if old is None:
            _os.environ.pop("TPUDF_INT8_KERNELS", None)
        else:
            _os.environ["TPUDF_INT8_KERNELS"] = old
    b, s, w, heads, hd, inter = QC_BLOCK
    bp = k7_tree(randn, wq_of, w, inter, dev)
    cfg = SigLIPConfig(w, 1, heads, inter, 128, 16, with_head=False)
    x = randn(b, s, w).to(bf)
    try:
        for route, expect in (
                ("LLL", {int8_block.KERNEL_LAYER_SPLIT: 1}),
                ("PPP", {int8_block.KERNEL_LN_QKV_SPLIT: 1,
                         int8_block.KERNEL_ATTN_OUT_SPLIT: 1,
                         mlp.KERNEL: 1})):
            _os.environ["TPUDF_INT8_KERNELS"] = route
            LAUNCHES.reset()
            out = _block_apply(x, bp, cfg)
            torch.cuda.synchronize()
            got = LAUNCHES.snapshot()
            check_launches(f"the queue's block {route}", got, expect)
            launches.update(got)
            twin = _block_apply(x, bp, cfg, kernels=TWINS)
            check_close(f"the queue's block {route}", out, twin, atol=5e-2,
                        rtol=2e-2)
            print(f"  the queue's block {(b, s, w)} {route}: launches {got}; "
                  f"max|Δ| vs twins {max_abs(out, twin):.3e} [{card}]",
                  flush=True)
            if route == "LLL":
                rec.add("K7-split", "siglip_layer_int8_split", (b, s, w),
                        max_abs(out, twin),
                        lambda: int8_block.siglip_layer_int8(x, bp, heads,
                                                             hd),
                        lambda: int8_block.siglip_layer_int8_reference(
                            x, bp, heads, hd),
                        ({"int8": 2 * b * s * w * (4 * w + 2 * inter),
                          "bf16": 4 * b * heads * s * s * hd},
                         nbytes(x, *[t for wq in (bp["attn"]["qkv_w"],
                                                  bp["attn"]["out_w"],
                                                  bp["mlp"]["fc1_w"],
                                                  bp["mlp"]["fc2_w"])
                                     for t in (wq["q"], wq["scale"])])
                         + nbytes(x)),
                        library=split_parts(b, s, heads, hd, inter, bp,
                                            mlp=True),
                        device_time=True)
    finally:
        if old is None:
            _os.environ.pop("TPUDF_INT8_KERNELS", None)
        else:
            _os.environ["TPUDF_INT8_KERNELS"] = old
    # K6's split route alone at the block's attention
    qkv = sharp_qkv(randn, b, s, heads, hd, hd)
    wq, bias = bp["attn"]["out_w"], bp["attn"]["out_b"]
    a = bp["act_scales"]["out"]
    rec.add("K6-split", "attn_out_int8_split", (b, s, 3 * w, w),
            max_abs(int8_block.attn_out_int8(qkv, x, wq, bias, a, heads, hd),
                    int8_block.attn_out_reference(qkv, x, wq, bias, a, heads,
                                                  hd)),
            lambda: int8_block.attn_out_int8(qkv, x, wq, bias, a, heads, hd),
            lambda: int8_block.attn_out_reference(qkv, x, wq, bias, a, heads,
                                                  hd),
            ({"bf16": 4 * b * heads * s * s * hd, "int8": 2 * b * s * w * w},
             nbytes(qkv, x, wq["q"], wq["scale"], bias, a) + nbytes(x)),
            library=split_parts(b, s, heads, hd, inter, bp, mlp=False),
            device_time=True)
    torch.cuda.empty_cache()
    return launches


def split_parts(b, s, heads, hd, inter, bp, mlp):
    """The PyTorch parts of a W8A8 layer at (b, s, heads x hd), as the K6 /
    K7 rows above them carry: SDPA in bf16 and `torch._int_mm` of the
    out-projection (K6), with the QKV, fc1 and fc2 products (K7), on
    seeded operands of the layer's shapes."""
    import torch
    import torch.nn.functional as F
    dev = bp["attn"]["out_w"]["q"].device
    g = torch.Generator(device=dev).manual_seed(5)
    w, m = heads * hd, b * s
    q, k, v = (torch.randn((b, heads, s, hd), generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    codes = lambda n, c: torch.randint(-127, 128, (n, c), generator=g,
                                       device=dev, dtype=torch.int8)
    a8, h8 = codes(m, w), codes(m, inter)
    wt = lambda name: bp[name[0]][name[1]]["qT"].t()
    parts = {"part attention SDPA":
             lambda: F.scaled_dot_product_attention(q, k, v),
             "part out-proj _int_mm":
             lambda: torch._int_mm(a8, wt(("attn", "out_w")))}
    if mlp:
        parts = {"part QKV _int_mm":
                 lambda: torch._int_mm(a8, wt(("attn", "qkv_w"))), **parts,
                 "part fc1 _int_mm":
                 lambda: torch._int_mm(a8, wt(("mlp", "fc1_w"))),
                 "part fc2 _int_mm":
                 lambda: torch._int_mm(h8, wt(("mlp", "fc2_w")))}
    return parts


def k3_fault(gray, fault):
    """K3's twin (f64 sums) with a planted fault of the strip kernel: "halo
    rows zeroed" (each strip's residuals with zeros past its own rows),
    "a strip's partial missing" (the second strip's pixels left out of the
    sums, not of the count), "clamped border" (the image's edge pixels
    repeated in place of the zero border)."""
    import torch
    import torch.nn.functional as F
    from tpudf_torch.ops import srm
    b, h, w = gray.shape
    rows = srm.srm_plan(b, h, w)[0]
    ks = [torch.from_numpy(srm._norm(k)).to(gray.device)
          for k in (srm._K2, srm._K3)]

    def taps(p, k):
        acc = torch.zeros_like(p[:, 1:-1, 1:-1])
        for di in range(3):
            for dj in range(3):
                if float(k[di, dj]) != 0.0:
                    acc = acc + p[:, di:di + p.shape[1] - 2,
                                  dj:dj + p.shape[2] - 2] * k[di, dj]
        return acc

    keep = torch.ones((h,), dtype=torch.bool, device=gray.device)
    res = []
    for k in ks:
        if fault == "clamped border":
            r = taps(F.pad(gray[:, None], (1, 1, 1, 1),
                           mode="replicate")[:, 0], k)
        elif fault == "halo rows zeroed":
            r = torch.cat([taps(F.pad(gray[:, r0:r0 + rows], (1, 1, 1, 1)),
                                k) for r0 in range(0, h, rows)], 1)
        else:
            r = taps(F.pad(gray, (1, 1, 1, 1)), k)
        res.append(r)
    if fault == "a strip's partial missing":
        keep[rows:2 * rows] = False
    out = []
    for r in res:
        v = r[:, keep].double().reshape(b, -1)
        out += [v.sum(1), (v ** 2).sum(1), (v ** 3).sum(1), (v ** 4).sum(1)]
    return (torch.stack(out, -1) / (h * w)).float()


def k3_checks(rec, dev, card):
    """Phase 2m, K3 on its strips at K3_BATCHES (256 x 256 images): within
    atol 1e-6 / rtol 1e-4 of the twin, bit-identical over three launches,
    and each planted fault (halo rows zeroed, a strip's partial missing, a
    clamped border) at least twice that tolerance away; then its device
    time beside its bound and the library's parts (F.conv2d of both
    stencils, the four moments) into K3's row."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from tpudf_torch.ops import srm
    from tpudf_torch.ops import _build
    print("phase 2m: K3 (strips of rows over the card)", flush=True)
    lib = _build.load()
    for shape in [(b, 256, 256) for b in K3_BATCHES] + [(3, 37, 61),
                                                        (1, 5, 5000)]:
        card_plan = tuple(lib.tpudf_srm_plan(*shape, i) for i in range(4))
        if card_plan != srm.srm_plan(*shape):
            raise AssertionError(f"K3 {shape}: plan {card_plan} on the card, "
                                 f"{srm.srm_plan(*shape)} in Python")
    g = torch.Generator(device=dev).manual_seed(89)
    stencils = torch.from_numpy(np.stack(
        [srm._norm(srm._K2), srm._norm(srm._K3)]))[:, None].to(dev)
    powers = torch.arange(1, 5, device=dev, dtype=torch.float32)
    for b in K3_BATCHES:
        gray = torch.rand((b, 256, 256), generator=g, device=dev)
        got = [srm.srm_raw_moments(gray) for _ in range(3)]
        ref = srm.srm_raw_moments_reference(gray)
        torch.cuda.synchronize()
        label = f"K3 {(b, 256, 256)} {srm.srm_plan(b, 256, 256)}"
        check_close(label, got[0], ref, atol=1e-6, rtol=1e-4)
        if not all(torch.equal(got[0], o) for o in got[1:]):
            raise AssertionError(f"{label}: not bit-identical over launches")
        factors = {f: fails_by(got[0], k3_fault(gray, f), 1e-6, 1e-4)
                   for f in ("halo rows zeroed", "a strip's partial missing",
                             "clamped border")}
        sound = fails_by(got[0], k3_fault(gray, None), 1e-6, 1e-4)
        print(f"  {label}: bit-identical over 3 launches; max|Δ| vs twin "
              f"{max_abs(got[0], ref):.3e}, vs its f64 form {sound:.3g}x the "
              f"tolerance [{card}]", flush=True)
        if sound > 1.0:
            raise AssertionError(f"{label}: off its f64 form")
        print(f"  {label}: planted faults fail by "
              + ", ".join(f"{k} {v:.3g}x" for k, v in factors.items())
              + f" [{card}]", flush=True)
        if min(factors.values()) < 2.0:
            raise AssertionError(f"{label}: a planted fault under 2x")
        ms = device_ms(lambda: srm.srm_raw_moments(gray))
        conv = device_ms(lambda: F.conv2d(gray[:, None], stencils,
                                          padding=1))
        res = F.conv2d(gray[:, None], stencils, padding=1)
        mom = device_ms(lambda: torch.mean(res[..., None] ** powers,
                                           dim=(2, 3)))
        b_ms, b_by = bound({"f32": K3_OPS_PER_PIXEL * gray.numel()},
                           nbytes(gray) + nbytes(got[0]))
        rec.rows["K3"].setdefault("device", []).append(
            {"shape": (b, 256, 256), "device_ms": ms, "bound_ms": b_ms,
             "bound_by": b_by, "library_part_ms": {
                 "F.conv2d (both stencils)": conv, "moments": mom}})
        print(f"  K3 {(b, 256, 256)} alone, device: {ms:.4f} ms; bound "
              f"{b_ms:.4f} ({b_by}, {ms / b_ms:.1f}x); parts F.conv2d "
              f"{conv:.4f} + moments {mom:.4f} [{card}]", flush=True)
        del gray, got, ref, res


# The image report (phase 3r, `report_paths`; phase 4, `report_timings`):
# requests of REPORT_BATCH images through tpudf_torch.serve.report at
# base-256 and large-384, engines A and B. Kernels vs twins on the same
# pixels: strings, ints and bools equal (a label, code or risk_idx that
# differs must be shown to be a step at a threshold: `report_tie`), floats
# the core reaches by PERF.md §6's engine rule (REPORT_CORE / REPORT_LOGIT,
# engine B's twice), the battery's floats by the goldens' rule; the
# battery on the card against the port's battery on the CPU for the same
# pixels by the goldens' rule, a cue outside it shown to be a step at ties
# of its binning (`battery_steps`: CUDA divides by a scalar through its
# reciprocal, so hue / 5 or a grey level may land on the other side of a
# bin edge than on the CPU).
REPORT_BATCH = {"full": 8, "fast": 32}
REPORT_CORE, REPORT_LOGIT = 1e-2, 5e-2
REPORT_GOLDEN = (2e-4, 2e-3)
REPORT_BATTERY_ONLY = ("forensic_score", "jpeg_q_mismatch_score",
                       "saturation_peak_score", "cfa_fake_score",
                       "prnu_strength_raw", "rendering_pipeline_score",
                       "jpeg", "face_retouch_score")
# the floats the label cascade and the verdict compare with a threshold
REPORT_DECIDING = ("final_prob", "visual_head", "freq_head", "head_delta",
                   "patch_mean", "max_patch", "patch_spread", "p_fake_coral",
                   "generator_likelihood", "bayes_final_prob",
                   "bayesian_fusion_posterior", "bayesian_fusion_certainty",
                   "dirichlet_uncertainty", "dirichlet_conflict", "entropy",
                   "face_p_fake", "xgb_fusion_prob")
REPORT_THRESHOLDS = (0.15, 0.18, 0.20, 0.25, 0.30, 0.35, 0.40, 0.45, 0.50,
                     0.55, 0.60, 0.65, 0.70, 0.75, 0.80, 0.85, 0.90, 1.0)


def report_images(n, size, seed):
    """n uint8 (size, size, 3) images: the golden corpus' structured
    recipe (gradients, a square-wave texture, noise, a pasted flat patch
    on every third) on the even ones, uniform noise on the odd ones."""
    import numpy as np
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    out = []
    for i in range(n):
        if i % 2:
            out.append(rng.integers(0, 256, (size, size, 3), np.uint8))
            continue
        k = i // 2 % 3
        base = 0.45 + 0.3 * np.sin((2 + k) * yy + (3 - k) * xx)[..., None] \
            * np.ones((1, 1, 3))
        tex = 0.08 * np.sign(np.sin(xx * np.pi * (8 + 8 * k))
                             * np.cos(yy * np.pi * 16))[..., None]
        img = base + tex + 0.05 * rng.standard_normal((size, size, 3))
        if k == 2:
            a, b = 5 * size // 16, 11 * size // 16
            img[a:b, a:b] = img[a:b, a:b].mean((0, 1))
        out.append((np.clip(img, 0, 1) * 255).astype(np.uint8))
    return np.stack(out)


def report_limit(key, w8a8):
    """Absolute limit of a float key, kernels vs twins; None: the goldens'
    rule (the battery's floats, which the core does not reach)."""
    leaf = key.split(".")[-1].split("[")[0]
    if leaf.startswith("forensic_") or leaf in REPORT_BATTERY_ONLY:
        return None
    vis = 2.0 if w8a8 else 1.0
    return (REPORT_LOGIT if leaf in ("z_sig", "z_freq") else REPORT_CORE) \
        * vis


def report_tie(got, want, w8a8):
    """A label, code or risk_idx difference shown to be a step at a
    threshold: a float the cascade reads lies on both sides of one of its
    thresholds in the two reports, within its limit; risk_idx: the twin's
    two largest risk_probs within the limit of each other."""
    lim = REPORT_CORE * (2.0 if w8a8 else 1.0)
    for k in REPORT_DECIDING:
        a, b = got.get(k), want.get(k)
        if a is None or b is None or abs(a - b) > lim:
            continue
        if any((a - t) * (b - t) <= 0 for t in REPORT_THRESHOLDS):
            return k
    for v in ("prob_fake", "certainty"):
        a, b = got["verdict"][v], want["verdict"][v]
        if abs(a - b) <= lim and any((a - t) * (b - t) <= 0
                                     for t in REPORT_THRESHOLDS):
            return f"verdict.{v}"
    return None


# the booster's 19 features (serve/report.py's order) as the report
# carries them; None: the disabled edge-continuity feature (0)
GBDT_FEATURES = ("z_sig", "z_freq", "|z|", "visual_head", "freq_head",
                 "blend", "forensic_diffusion_v2",
                 "forensic_spectral_flatness", None,
                 "forensic_color_correlation", "forensic_jpeg_residual",
                 "embedding_anomaly", "max_patch", "patch_mean",
                 "patch_spread", "forensic_cfa_fake", "forensic_texture_noise",
                 "forensic_perlin", "head_delta")
# what the booster's probability decides in a report (p_blend = it)
GBDT_DECIDES = ("xgb_fusion_prob", "final_prob", "final_label",
                "prediction_code", "band", "band_text", "band_color",
                "risk_level", "label_trace", "tamper_votes", "real_gate",
                "three_way", "rbr")


def gbdt_features(r):
    """The booster's (19,) f32 features of a report."""
    import numpy as np
    f = []
    for k in GBDT_FEATURES:
        if k is None:
            f.append(0.0)
        elif k == "|z|":
            f.append(abs(np.float32(r["z_sig"]) - np.float32(r["z_freq"])))
        elif k == "blend":
            f.append(np.clip(np.float32(0.4) * np.float32(
                r["forensic_diffusion_v2"]) + np.float32(0.6) * np.float32(
                    r["forensic_cfa_fake"]), 0.0, 1.0))
        else:
            f.append(r[k])
    return np.asarray(f, np.float32)


def gbdt_step(g, w, gbdt, w8a8):
    """True when a booster probability that differs between two reports
    is a step of the tree walk at a threshold: the ensemble on the host
    gives each report's probability from that report's features, and every
    feature agrees within its limit (a feature crossing a node's
    threshold switches a leaf)."""
    import numpy as np
    import torch
    fg, fw = gbdt_features(g), gbdt_features(w)
    p = gbdt.to("cpu").predict_proba(torch.from_numpy(np.stack([fg, fw])))
    if np.abs(p.numpy() - [g["xgb_fusion_prob"], w["xgb_fusion_prob"]]
              ).max() > 1e-5:
        return False
    def limit(i, k):
        if k is None:
            return 0.0
        if k == "|z|":                  # |z_sig - z_freq|: both limits
            return 2 * report_limit("z_sig", w8a8)
        lim = None if k == "blend" else report_limit(k, w8a8)
        return (REPORT_GOLDEN[0] + REPORT_GOLDEN[1] * abs(fw[i])
                if lim is None else lim)
    return all(abs(a - b) <= limit(i, k) for i, (k, a, b) in
               enumerate(zip(GBDT_FEATURES, fg, fw)))


def report_vs(label, got, want, w8a8, gbdt=None):
    """Kernels' reports against the twins' on the same pixels. A float out
    of its limit fails; a string, int or bool that differs fails unless
    `report_tie` shows the image's difference to be a step at a threshold;
    with a booster attached, a probability that moves by a step of its
    tree walk (`gbdt_step`) takes what it decides out of the comparison
    for that image. Returns (max |Δ| of the core's floats, of the
    battery's, the ties)."""
    import math
    import re
    worst = {"core": 0.0, "battery": 0.0}
    num = r"-?\d+\.\d+"

    def walk(path, g, w, out):
        """Appends (path, is_float, message) for each disagreement."""
        if isinstance(w, dict):
            if set(g) != set(w):
                out.append((path, False, f"keys {set(g) ^ set(w)}"))
                return
            for k in w:
                walk(f"{path}.{k}", g[k], w[k], out)
        elif isinstance(w, list) and isinstance(g, list) \
                and len(g) == len(w):
            for i, (a, b) in enumerate(zip(g, w)):
                walk(f"{path}[{i}]", a, b, out)
        elif isinstance(w, float) and isinstance(g, float) \
                and not path.endswith(".prediction_code"):
            # (prediction_code is a float code of the label: a code, held
            # equal but for a step at a threshold, as the labels are)
            if math.isnan(w) or math.isnan(g):
                if not (math.isnan(w) and math.isnan(g)):
                    out.append((path, True, f"{g!r} != {w!r}"))
                return
            lim = report_limit(path, w8a8)
            kind = "battery" if lim is None else "core"
            if lim is None:
                lim = REPORT_GOLDEN[0] + REPORT_GOLDEN[1] * abs(w)
            worst[kind] = max(worst[kind], abs(g - w))
            if abs(g - w) > lim:
                out.append((path, True, f"{g!r} != {w!r}"))
        elif path.endswith("verdict.reason"):
            lim = report_limit("verdict", w8a8) + 5e-4
            if re.sub(num, "#", g) != re.sub(num, "#", w) or any(
                    abs(float(a) - float(b)) > lim for a, b in
                    zip(re.findall(num, g), re.findall(num, w))):
                out.append((path, False, f"{g!r} != {w!r}"))
        elif g != w:
            out.append((path, False, f"{g!r} != {w!r}"))

    errors, ties = [], []
    if len(got) != len(want):
        errors.append(f"{len(got)} reports != {len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        out = []
        walk(f"img{i}", g, w, out)
        if out and gbdt is not None and any(
                p.endswith(".xgb_fusion_prob") for p, _, _ in out) \
                and gbdt_step(g, w, gbdt, w8a8):
            ties.append(f"img{i} at a node of the booster: xgb "
                        f"{g['xgb_fusion_prob']:.4f} / "
                        f"{w['xgb_fusion_prob']:.4f}")
            out = [e for e in out if e[0].split(".")[1].split("[")[0]
                   not in GBDT_DECIDES]
        tie = report_tie(g, w, w8a8) if out else None
        if out and tie and not any(is_float for _, is_float, _ in out):
            ties.append(f"img{i} at {tie}: "
                        + "; ".join(f"{p} {m}" for p, _, m in out))
        else:
            errors += [f"{p}: {m}" for p, _, m in out]
    if errors:
        raise AssertionError(f"{label}: kernels vs twins disagree: "
                             + "; ".join(errors[:12]))
    return worst["core"], worst["battery"], ties


def report_plain(reports):
    """The reports as JSON would carry them (numpy scalars to floats)."""
    return json.loads(json.dumps(reports, default=float))


def battery_steps(bad, cues, ref, img, img_ref):
    """Show each cue of `bad` (outside the goldens' rule between the
    card's battery `cues` on its input `img` and the CPU's `ref` on
    `img_ref`) to be a step at ties: for a binned cue (forensics.TIE_STEPS)
    the float it bins agrees between the two runs but for rounding (99.9 %
    of them within 1e-4 relative; the hue of a near-grey pixel divides its
    input's rounding by a small chroma), and its binning on the CPU gives
    each run's value from that run's floats; a
    composite (TIE_LINEAR) moves by its weights times the binned cues'
    steps. Returns {cue: |Δ|}; raises if a cue is neither."""
    import numpy as np
    import torch
    from tpudf_torch.ops.forensics import TIE_LINEAR, TIE_STEPS, _gray
    atol, rtol = REPORT_GOLDEN
    close = lambda a, b: np.all(np.abs(a - b) <= atol + rtol * np.abs(b))
    shown = {}
    for k in bad:
        d = np.abs(cues[k] - ref[k])
        if k in TIE_STEPS:
            pre, post = TIE_STEPS[k]
            with torch.no_grad():
                a = pre(img, _gray(img)).cpu().double()
                b = pre(img_ref, _gray(img_ref)).double()
            gap = (a - b).abs()
            if k == "color_harmony":        # hue / 5 wraps at 36
                gap = torch.minimum(gap, 36.0 - gap)
            rel = (gap / torch.maximum(a.abs(), b.abs()).clamp_min(1.0))
            rel = rel.reshape(-1)
            if float(torch.kthvalue(rel, max(1, int(0.999 * rel.numel())))
                     .values) > 1e-4:
                raise AssertionError(f"{k}: the binned floats differ by "
                                     f"more than rounding")
            if not (close(post(a.float()).numpy(), cues[k])
                    and close(post(b.float()).numpy(), ref[k])):
                raise AssertionError(f"{k}: its binning does not give "
                                     f"both runs' values")
        elif k in TIE_LINEAR:
            moved = sum(w * (cues[s] - ref[s])
                        for s, w in TIE_LINEAR[k].items())
            if not close(cues[k] - moved, ref[k]):
                raise AssertionError(f"{k}: not its binned cues' steps")
        else:
            raise AssertionError(f"{k}: |Δ| {d.max():.3e}, not a binned "
                                 f"cue")
        shown[k] = float(d.max())
    return shown


def battery_vs_cpu(label, reports, px):
    """The battery's cues of the card's reports against the port's battery
    on the CPU for the same pixels (resized to 256 px on the CPU where the
    tail resizes), by the goldens' rule; a cue outside it must be shown to
    be a step at ties (`battery_steps`). Returns (the largest |Δ| within
    the rule, the steps shown)."""
    import numpy as np
    import torch
    from tpudf_torch.data.pipeline import resize
    from tpudf_torch.ops.forensics import BATTERY_KEYS, forensic_battery

    def prepared(dev):
        x = torch.from_numpy(px).to(dev).float() / 255.0
        if px.shape[1] != 256:
            x = resize(x, (x.shape[0], 256, 256, 3), "bilinear")
        return x

    img, img_ref = prepared("cuda"), prepared("cpu")
    ref = {k: v.numpy() for k, v in forensic_battery(img_ref).items()}
    cues = {k: np.asarray([r[f"forensic_{k}"] for r in reports],
                          np.float32) for k in BATTERY_KEYS}
    worst, bad = 0.0, []
    for k in BATTERY_KEYS:
        d = np.abs(cues[k] - ref[k])
        if (d > REPORT_GOLDEN[0] + REPORT_GOLDEN[1] * np.abs(ref[k])).any():
            bad.append(k)
        else:
            worst = max(worst, float(d.max()))
    try:
        steps = battery_steps(bad, cues, ref, img, img_ref)
    except AssertionError as err:
        raise AssertionError(f"{label}: the card's battery vs the CPU's: "
                             f"{err}") from None
    return worst, steps


def report_request(label, eng, tw, px, fast, w8a8, expect, twin_images,
                   escalations=0):
    """One report request with the launch counts set to 0 just before it:
    exact launches (the engine's request's, once more per escalation
    request), every report whole and finite where it must be; then the
    first `twin_images` images through the twins: `report_vs`. Returns
    (reports, launches, core |Δ|, battery |Δ|, ties)."""
    import torch
    from tpudf_torch.core.backend import LAUNCHES
    from tpudf_torch.serve.report import predict_images
    LAUNCHES.reset()
    reps = predict_images(eng, px, fast=fast)
    launches = LAUNCHES.snapshot()
    want = {k: v * (1 + escalations) for k, v in expect.items()}
    check_launches(f"{label} B={px.shape[0]}", launches, want)
    reps = report_plain(reps)
    for i, r in enumerate(reps):
        if len(r) < (80 if not fast else 75):
            raise AssertionError(f"{label}: report {i} has {len(r)} keys")
        for k, v in r.items():
            if isinstance(v, float) and not (v == v) and k != "xgb_fusion_prob":
                raise AssertionError(f"{label}: report {i} {k} is NaN")
        if not 0.0 <= r["final_prob"] <= 1.0:
            raise AssertionError(f"{label}: final_prob {r['final_prob']}")
    n = twin_images or px.shape[0]
    got = reps[:n] if n == px.shape[0] else report_plain(
        predict_images(eng, px[:n], fast=fast))
    LAUNCHES.reset()
    ref = report_plain(predict_images(tw, px[:n], fast=fast))
    torch.cuda.synchronize()
    if LAUNCHES.snapshot():
        raise AssertionError(f"{label}: twins launched "
                             f"{LAUNCHES.snapshot()}")
    core, batt, ties = report_vs(label, got, ref, w8a8, eng.gbdt)
    return reps, launches, core, batt, ties


def report_paths(dev, card, backbones):
    """`_report_paths` with cuDNN's TF32 at PyTorch's default (on): the
    tail must keep its convolutions in f32 itself (forensics.f32_math);
    the script's own setting (off) comes back after."""
    import torch
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        return _report_paths(dev, card, backbones)
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _report_paths(dev, card, backbones):
    """Phase 3r: the image report at full width. backbones: {name:
    (engines {"A", "B"}, expected launches per (engine, mode), twin
    images)}. For each backbone, engine and mode, a report request of
    REPORT_BATCH images (`report_request`: exact launches, kernels vs
    twins) and, once per backbone, the battery on the card against the
    CPU's (`battery_vs_cpu`); at large-384, engine B's full request once
    with the three artifacts attached (mean_real, a TreeEnsemble fitted by
    train/gbdt.py on seeded 19-d features, an isotonic BayesCalibration)
    and once with a face box on every image that escalates (one more
    engine request); then planted faults that the same checks must catch:
    the tail fed the un-resized 384 px pixels, the full path's tail
    reading the columns of the fast path's core; TF32 left on in the tail
    is reported. Returns what phase 4 times."""
    import contextlib
    import dataclasses

    import numpy as np
    import torch
    from tpudf_torch.fuse.bayesian import FEATURES, fit_bayes_calibration
    from tpudf_torch.ops import forensics
    from tpudf_torch.ops.routes import TWINS
    from tpudf_torch.serve import face, report
    from tpudf_torch.train.gbdt import to_tree_ensemble, train_gbdt

    print("phase 3r: the image report (battery, fusion tail, label cascade, "
          "verdict) at base-256 and large-384", flush=True)
    state = {"requests": {}, "launches": {}}
    for name, (engines, expect, twin_images) in backbones.items():
        size = engines["A"].cfg.image_size
        reqs = {m: report_images(b, size, seed=20 + b)
                for m, b in REPORT_BATCH.items()}
        state["requests"][name] = (engines, reqs)
        for e, eng in engines.items():
            tw = dataclasses.replace(eng, kernels=TWINS)
            for mode, px in reqs.items():
                label = f"report {name} engine {e} {mode}"
                reps, launched, core, batt, ties = report_request(
                    label, eng, tw, px, mode == "fast", e == "B",
                    expect[(e, mode)], twin_images)
                state["launches"][(name, e, mode)] = launched
                labels = collections.Counter(r["final_label"] for r in reps)
                print(f"{label} B={px.shape[0]}: launches {launched} (the "
                      f"engine request's); vs twins on "
                      f"{twin_images or px.shape[0]} images: strings equal, "
                      f"max|Δ| core {core:.3e}, battery {batt:.3e}; ties "
                      f"{ties or 'none'}; labels {dict(labels)} [{card}]",
                      flush=True)
                if e == "A" and mode == "full":
                    d, steps = battery_vs_cpu(label, reps, px)
                    print(f"  battery on the card vs the CPU ({px.shape[0]} "
                          f"images): max|Δ| {d:.3e} (goldens' rule); steps "
                          f"at ties shown: " + (", ".join(
                              f"{k} |Δ| {v:.3e}" for k, v in steps.items())
                              or "none") + f" [{card}]", flush=True)
                torch.cuda.empty_cache()

    # ---- a report's device work launches without a sync: torch's sync
    # check set to raise around dispatch_images (the engine's core, the
    # tail, the face step), each engine and mode after its warm requests
    for name, (engines, reqs) in state["requests"].items():
        for e, eng in engines.items():
            for mode, px in reqs.items():
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    report.dispatch_images(eng, px, mode == "fast")
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                torch.cuda.synchronize()
    print(f"  dispatch_images launched with no sync (torch's sync check "
          f"raising) at both backbones, engines A and B, full and fast",
          flush=True)

    name = "large-384"
    engines, reqs = state["requests"][name]
    eng_b, px = engines["B"], reqs["full"]
    expect, twin_images = backbones[name][1], backbones[name][2]
    tw_b = dataclasses.replace(eng_b, kernels=TWINS)

    # ---- the three artifacts attached
    rng = np.random.default_rng(31)
    x19 = rng.random((400, 19))
    y19 = (rng.random(400) < 0.2 + 0.6 * x19[:, 3]).astype(np.float64)
    held = {k: rng.random(300) for k in FEATURES}
    y7 = (rng.random(300) < 0.3 + 0.4 * held["forensic"]).astype(float)
    arts = dict(mean_real=rng.standard_normal(eng_b.cfg.width).astype(
                    np.float32),
                gbdt=to_tree_ensemble(train_gbdt(x19, y19, n_trees=20,
                                                 depth=3), 1.2, -0.1),
                bayes_calibration=fit_bayes_calibration(held, y7))
    for k, v in arts.items():
        setattr(eng_b, k, v)
        setattr(tw_b, k, v)
    label = f"report {name} engine B full, artifacts attached"
    reps, launched, core, batt, ties = report_request(
        label, eng_b, tw_b, px, False, True, expect[("B", "full")],
        twin_images)
    if any(r["xgb_fusion_prob"] is None for r in reps) or not any(
            r["embedding_cos_dev"] > 0 for r in reps):
        raise AssertionError(f"{label}: the artifacts did not reach the "
                             f"report")
    print(f"{label} B={px.shape[0]}: launches {launched}; vs twins: max|Δ| "
          f"core {core:.3e}, battery {batt:.3e}; ties {ties or 'none'}; "
          f"xgb_fusion_prob mean "
          f"{np.mean([r['xgb_fusion_prob'] for r in reps]):.4f} [{card}]",
          flush=True)
    for k in arts:
        setattr(eng_b, k, None)
        setattr(tw_b, k, None)

    # ---- a forced face box that escalates (the crop 1.5 x the box side,
    # 75 % of the frame's side: >= 8 % of the frame and >= 96 px)
    orig = face.detect_faces
    box = (size // 4, size // 4, size // 2, size // 2)
    face.detect_faces = lambda img, min_size=48: [box]
    try:
        label = f"report {name} engine B full, a face on every image"
        reps, launched, core, batt, ties = report_request(
            label, eng_b, tw_b, px, False, True, expect[("B", "full")],
            twin_images, escalations=1)
    finally:
        face.detect_faces = orig
    if any(r["face_p_fake"] is None or r["face_retouch_score"] is None
           for r in reps):
        raise AssertionError(f"{label}: the face escalation did not run")
    print(f"{label} B={px.shape[0]}: launches {launched} (the engine "
          f"request's twice: the escalation is one more request); vs twins: "
          f"max|Δ| core {core:.3e}, battery {batt:.3e}; ties "
          f"{ties or 'none'}; face_p_fake mean "
          f"{np.mean([r['face_p_fake'] for r in reps]):.4f} [{card}]",
          flush=True)

    # ---- planted faults: each must fail the checks above
    def fault_unresized():
        orig_resize = report.resize
        report.resize = lambda x, shape, method, antialias=True: x
        try:
            reps = report_plain(report.predict_images(eng_b, px[:2]))
        finally:
            report.resize = orig_resize
        battery_vs_cpu("fault", reps, px[:2])

    def fault_fast_columns():
        undo = fault_fast_tail(eng_b)
        try:
            got = report_plain(report.predict_images(eng_b, px[:2]))
        finally:
            undo()
        report_vs("fault", got, report_plain(
            report.predict_images(tw_b, px[:2])), True)

    def fault_tf32():
        prev = torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32
        orig_f32 = forensics.f32_math, report.f32_math
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        forensics.f32_math = report.f32_math = contextlib.nullcontext
        try:
            reps = report_plain(report.predict_images(eng_b, px[:2]))
        finally:
            forensics.f32_math, report.f32_math = orig_f32
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = prev
        battery_vs_cpu("fault", reps, px[:2])

    for fault, required in ((fault_unresized, True),
                            (fault_fast_columns, True), (fault_tf32, False)):
        try:
            fault()
        except AssertionError as err:
            print(f"  planted fault {fault.__name__[6:]}: caught ({str(err)[:160]})",
                  flush=True)
            continue
        if required:
            raise AssertionError(f"report: the checks miss the planted fault "
                                 f"{fault.__name__[6:]}")
        print(f"  planted fault {fault.__name__[6:]}: within the checks "
              f"(reported, not required)", flush=True)
    return state


def report_timings(state, card):
    """Phase 4: each report request of phase 3r by the host clock (the
    request ends in its one device→host copy), and its parts each alone:
    the engine's core (CUDA events around `dispatch_batch`), the fusion
    tail (CUDA events around the tail on that core), the face step (host
    clock: cv2's Haar detection and its launches) and the finish (host
    clock: the copy, the cascade and the verdict, the card idle). In the
    request the tail's launches overlap the core's device work, so the
    parts need not sum to it. A profile of base-256 engine A's and
    large-384 engine B's full request gives the device's idle share."""
    import torch
    from tpudf_torch.serve import report
    from tpudf_torch.serve.engine import to_device

    for name, (engines, reqs) in state["requests"].items():
        for e, eng in engines.items():
            for mode, px in reqs.items():
                fast = mode == "fast"
                b = px.shape[0]
                run = lambda: report.predict_images(eng, px, fast=fast)
                run()
                torch.cuda.synchronize()
                iters = 3
                t0 = time.perf_counter()
                for _ in range(iters):
                    run()
                total = (time.perf_counter() - t0) / iters * 1e3
                dpx = to_device(px, eng.device)
                core_ms = cuda_ms(lambda: eng.dispatch_batch(dpx, fast),
                                  iters=iters, warmup=1)
                core = eng.dispatch_batch(dpx, fast)
                tail, _ = report._fusion_tail_for(eng, fast)
                tail_ms = cuda_ms(lambda: tail(core, dpx), iters=iters,
                                  warmup=1)
                # the host's parts, each alone with the card idle: the face
                # step (cv2's Haar detection, then its device launches) and
                # the finish (the one copy, the cascade and the verdict)
                face_ms = 0.0
                if not fast:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    report._dispatch_face(eng, px)
                    face_ms = (time.perf_counter() - t0) * 1e3
                done = report.dispatch_images(eng, px, fast)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                report.predict_images(eng, px, fast=fast, _dispatched=done)
                finish_ms = (time.perf_counter() - t0) * 1e3
                print(f"report {name} engine {e} {mode} B={b}: request "
                      f"{total:.3f} ms = {b * 1e3 / total:.1f} img/s (host "
                      f"clock); alone: engine core {core_ms:.3f} ms, fusion "
                      f"tail {tail_ms:.3f} ms (CUDA events), face step "
                      f"{face_ms:.3f} ms, copy + cascade + verdict "
                      f"{finish_ms:.3f} ms (host clock) [{card}]",
                      flush=True)
                if (name, e, mode) in (("base-256", "A", "full"),
                                       ("large-384", "B", "full")):
                    profile(run, f"report {name} engine {e} {mode} B={b}",
                            card, iters=2, top=10)
                del core
                torch.cuda.empty_cache()


# The video report (phase 3v, `video_paths`; phase 4, `video_timings`):
# tpudf_torch.serve.report.predict_video on clips of VIDEO_T frames at the
# engine's image size, base-256 and large-384, engines A and B, once with
# the kernels and once through the twins. The battery's signals are
# bit-equal between the two (the same code on the same device) but for
# the tower's id_drift (and the face pair when the face trio embeds with
# the tower); the tower's floats by PERF.md §6's engine rule (engine B
# twice); a label, code, bool or the chosen frame that differs must be
# shown to be a step at a threshold (`video_tie`). The battery on the card
# against the port's on the CPU by the goldens' rule, a thresholded cue
# outside it shown to be a step (`video_steps`: its float fields agree
# but for rounding, and its threshold applied on the CPU gives each run's
# value from that run's fields). The face nets and the face trio on the
# card against the port's on the CPU (`face_vs_cpu`).
VIDEO_T = 12
VIDEO_CUT = 6
VIDEO_FLAG = (0.50, 0.55, 0.60)         # aggregate_sora's hit thresholds


def video_clip(t, size, seed, cut=None):
    """t uint8 frames: the golden corpus' structured recipe, frame i rolled
    2 i px along x (tests/test_report_golden.py's clip); with `cut`, the
    frames from `cut` on show another image (a scene cut)."""
    import numpy as np
    first = report_images(1, size, seed)[0]
    second = report_images(5, size, seed + 1)[4]
    return np.stack([np.roll(first if cut is None or i < cut else second,
                             2 * i, axis=1) for i in range(t)])


def tower_expect(layers, e):
    """Launches of one tower forward without ToMe (embed_frames) of
    engine A (bf16) or B (W8A8)."""
    from tpudf_torch.ops import attention, int8_block, layernorm, linear, mlp
    if e == "A":
        return {linear.KERNEL: 2 * layers, attention.KERNEL: layers,
                mlp.KERNEL_BF16: layers, layernorm.KERNEL: 2}
    return {int8_block.KERNEL: layers, mlp.KERNEL: layers,
            layernorm.KERNEL: 2}


def video_expect(expect, layers, e, towers, escalations):
    """Launches of one video request: the frames' fast batch, `towers`
    tower forwards without ToMe (the battery's embeddings, and the face
    trio's when it embeds with the tower), the chosen frame's full
    request (twice when its face escalates)."""
    n = collections.Counter(expect[(e, "fast")])
    for _ in range(towers):
        n.update(tower_expect(layers, e))
    for _ in range(1 + escalations):
        n.update(expect[(e, "full")])
    return dict(n)


def face_branch(clip, dev):
    """(the face trio's branch, frames with a face): the landmark net when
    it finds a face on 3 frames or more, else Haar."""
    from tpudf_torch.serve import face
    lms, _ = face._clip_landmarks(list(clip), face.get_landmark_params(dev))
    if lms is not None:
        return "landmark net", sum(l is not None for l in lms)
    return "Haar", sum(bool(face.detect_faces(f)) for f in clip)


def video_tie(got, want, w8a8):
    """A video label, bool, count or chosen frame that differs shown to be
    a step at a threshold: a float the decision reads lies on both sides
    of one of its thresholds in the two reports, within its limit (sora's
    SORA_* tiers and its flag's 0.60 / 0.75, consistency's 0.60 / 0.70 /
    0.75, the strictness pair and the 0.75 escalation on the video and
    frame probabilities, the hit thresholds on a signal), or the two
    chosen frames' probabilities within the limit of each other. (A frame
    label is shown a step by its frame's report: `video_vs`.)"""
    from tpudf_torch.serve import report as rp
    lim = REPORT_CORE * (2.0 if w8a8 else 1.0)
    agg = want["aggregation"]
    pair = (agg["th_fake"], agg["th_real"], 0.75)
    sora = (rp.SORA_TAMPERED_THRESH, rp.SORA_TAMPERED_THRESH + 0.15,
            rp.SORA_FAKE_THRESH, 0.60, 0.75)
    cands = [("sora_likelihood", got["sora_likelihood"],
              want["sora_likelihood"], sora),
             ("temporal_consistency_score",
              got["temporal_consistency_score"],
              want["temporal_consistency_score"], (0.60, 0.70, 0.75)),
             ("aggregation.video_prob", got["aggregation"]["video_prob"],
              agg["video_prob"], pair)]
    cands += [(f"frame_probs[{i}]", a, b, pair)
              for i, (a, b) in enumerate(zip(got["frame_probs"],
                                             want["frame_probs"]))]
    gs, ws = got["temporal_signals"], want["temporal_signals"]
    cands += [(k, gs[k], ws[k], VIDEO_FLAG) for k in ws if k in gs]
    for name, a, b, ts in cands:
        if abs(a - b) <= lim and any((a - t) * (b - t) <= 0 for t in ts):
            return name
    i, j = got["chosen_frame"], want["chosen_frame"]
    if i != j and all(abs(r["frame_probs"][i] - r["frame_probs"][j]) <= lim
                      for r in (got, want)):
        return "chosen_frame"
    return None


def video_vs(label, got, want, w8a8, tower_face=False, frames=None):
    """A video report with the kernels against the twins' on the same
    frames (see above). Frame labels that differ are shown to be steps by
    the frames' fast reports (`frames()`: the kernels' and the twins'
    predict_images(fast=True), compared by `report_vs`); the label
    counts, the video label and the chosen frame follow them. Returns (max |Δ| of the tower's floats, the ties, the
    chosen frame report's (core |Δ|, battery |Δ|, ties))."""
    lim = REPORT_CORE * (2.0 if w8a8 else 1.0)
    errors, soft, worst = [], [], 0.0
    if set(got) != set(want):
        raise AssertionError(f"{label}: keys {set(got) ^ set(want)}")

    def tower(path, a, b):
        nonlocal worst
        worst = max(worst, abs(a - b))
        if abs(a - b) > lim:
            errors.append(f"{path}: {a!r} != {b!r}")

    gs, ws = got["temporal_signals"], want["temporal_signals"]
    if set(gs) != set(ws):
        errors.append(f"temporal_signals: keys {set(gs) ^ set(ws)}")
    by_tower = {"id_drift"} | ({"face_embedding_drift", "face_track_drift"}
                               if tower_face else set())
    for k in set(gs) & set(ws):
        if k in by_tower:
            tower(f"temporal_signals.{k}", gs[k], ws[k])
        elif gs[k] != ws[k]:
            errors.append(f"temporal_signals.{k}: {gs[k]!r} != {ws[k]!r} "
                          f"(not bit-equal)")
    for k in ("video_prob", "sora_likelihood"):
        tower(k, got[k], want[k])
    if got["temporal_consistency_score"] != want["temporal_consistency_score"]:
        errors.append("temporal_consistency_score not bit-equal")
    for i, (a, b) in enumerate(zip(got["frame_probs"], want["frame_probs"])):
        tower(f"frame_probs[{i}]", a, b)
    for k, b in want["aggregation"].items():
        a = got["aggregation"][k]
        if isinstance(b, float):
            tower(f"aggregation.{k}", a, b)
        elif a != b:
            soft.append(f"aggregation.{k}: {a!r} != {b!r}")
    for k in ("video_label", "chosen_frame", "sora_flag", "frame_labels"):
        if got[k] != want[k]:
            soft.append(f"{k}: {got[k]!r} != {want[k]!r}")
    if errors:
        raise AssertionError(f"{label}: kernels vs twins disagree: "
                             + "; ".join(errors[:12]))
    ties = []
    if got["frame_labels"] != want["frame_labels"]:
        _, _, frame_ties = report_vs(f"{label} frames", *frames(), w8a8)
        ties.append(f"frame labels at {frame_ties}")
        # the vote over the frame labels, and the frame it picks, follow
        soft = [m for m in soft if not m.startswith(
            ("frame_labels", "aggregation.label_counts", "video_label",
             "chosen_frame"))]
    if soft:
        tie = video_tie(got, want, w8a8)
        if tie is None:
            raise AssertionError(f"{label}: kernels vs twins disagree: "
                                 + "; ".join(soft))
        ties.append(f"at {tie}: " + "; ".join(soft))
    chosen = None
    if got["chosen_frame"] == want["chosen_frame"]:
        chosen = report_vs(f"{label} chosen frame",
                           [got["chosen_frame_report"]],
                           [want["chosen_frame_report"]], w8a8)
    return worst, ties, chosen


def video_tie_steps():
    """The battery's thresholded cues, each split at its threshold as (the
    float field of (T, 256, 256) grayscale, the cue from that field): the
    flow family past ops.flow.flow_fields, edge_flicker past its Sobel
    magnitude (fuse.temporal.edge_flicker's lines after it)."""
    import torch
    from tpudf_torch.ops.flow import flow_fields, flow_signals_from
    from tpudf_torch.ops.forensics import _std, sobel_mag

    def edge_flicker_from(mag, thresh=0.35):
        dens = torch.mean((mag > thresh * 255.0).float(), dim=(1, 2))
        cv = _std(dens, 0) / (torch.mean(dens) + 1e-6)
        return torch.clamp((cv - 0.15) / 0.50, 0.0, 1.0)

    return {"edge_flicker": (lambda gray: sobel_mag(gray * 255.0),
                             edge_flicker_from),
            **{k: (flow_fields, lambda f, k=k: flow_signals_from(*f)[k])
               for k in ("affine_inconsistency", "flow_dir_incoherence",
                         "flow_fb_inconsistency", "flow_reprojection",
                         "klt_instability", "parallax_err")}}


def video_steps(bad, card, cpu, gray, gray_ref):
    """Show each battery cue of `bad` (outside the goldens' rule between
    the card's value `card[k]` and the CPU's `cpu[k]`) to be a step at its
    threshold (`video_tie_steps`): the cue's float fields from the
    card's 256 px grey frames `gray` and the CPU's `gray_ref` agree but for
    rounding (99.9 % of elements within 1e-2 + 1e-4 |x|: flow fields in
    px), and the cue's threshold applied on the CPU to each run's fields
    gives that run's value. Returns {cue: |Δ|}; raises if a cue is
    neither."""
    import torch
    from tpudf_torch.ops.forensics import f32_math
    atol, rtol = REPORT_GOLDEN
    tie_steps = video_tie_steps()
    shown = {}
    fields = {}
    for k in bad:
        if k not in tie_steps:
            raise AssertionError(f"{k}: |Δ| {abs(card[k] - cpu[k]):.3e}, "
                                 f"not a thresholded cue")
        pre, post = tie_steps[k]
        if pre not in fields:
            with torch.no_grad(), f32_math():
                a = pre(gray)
                b = pre(gray_ref)
            tup = lambda f: f if isinstance(f, tuple) else (f,)
            fields[pre] = (tuple(f.cpu().double() for f in tup(a)),
                           tuple(f.double() for f in tup(b)))
        a, b = fields[pre]
        for fa, fb in zip(a, b):
            ok = (fa - fb).abs() <= 1e-2 + 1e-4 * fb.abs()
            if float(ok.float().mean()) < 0.999:
                raise AssertionError(f"{k}: its fields differ by more than "
                                     f"rounding")
        unpack = lambda f: f if len(f) > 1 else f[0]
        with torch.no_grad():
            va = float(post(unpack(tuple(f.float() for f in a))))
            vb = float(post(unpack(tuple(f.float() for f in b))))
        for v, want in ((va, card[k]), (vb, cpu[k])):
            if not (v == want or (v != v and want != want)
                    or abs(v - want) <= atol + rtol * abs(want)):
                raise AssertionError(f"{k}: its threshold does not give "
                                     f"both runs' values")
        shown[k] = abs(card[k] - cpu[k])
    return shown


_CPU_BATTERY = {}          # clip's sha1 → (the CPU's battery, its grey)


def video_battery_vs_cpu(label, rep, clip, dev):
    """The battery's signals of a video report on the card: bit-equal to
    the battery run on the card with TF32 off for cuDNN and cuBLAS
    globally (it keeps f32 itself, forensics.f32_math, whatever its
    caller set), and against the port's battery on the CPU for the same
    frames (resized to 256 px where the battery resizes) by the goldens'
    rule, a cue outside it shown to be a step (`video_steps`); NaN where
    the CPU gives NaN (a signal the report drops). Returns (the largest
    |Δ| within the rule, the steps shown)."""
    import torch
    from tpudf_torch.data.pipeline import resize
    from tpudf_torch.ops.forensics import _gray
    from tpudf_torch.serve.report import temporal_battery

    def prepared(dev):
        x = torch.from_numpy(clip).to(dev).float() / 255.0
        if clip.shape[1] != 256:
            x = resize(x, (x.shape[0], 256, 256, 3), "bilinear")
        return x

    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        x = prepared(dev)
        off = {k: float(v) for k, v in temporal_battery(x).items()}
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    key = hashlib.sha1(clip.tobytes()).hexdigest()
    if key not in _CPU_BATTERY:           # the faults reuse the clips
        x_ref = prepared("cpu")
        _CPU_BATTERY[key] = ({k: float(v) for k, v in temporal_battery(
            x_ref).items()}, _gray(x_ref))
    ref, gray_ref = _CPU_BATTERY[key]
    card = {k: rep["temporal_signals"].get(k, float("nan")) for k in ref}
    atol, rtol = REPORT_GOLDEN
    worst, bad = 0.0, []
    for k, r in ref.items():
        c = card[k]
        if r != r or c != c:
            if not (r != r and c != c):
                bad.append(k)
        elif abs(c - r) > atol + rtol * abs(r):
            bad.append(k)
        else:
            worst = max(worst, abs(c - r))
    try:
        steps = video_steps(bad, card, ref, _gray(x), gray_ref)
    except AssertionError as err:
        raise AssertionError(f"{label}: the card's battery vs the CPU's: "
                             f"{err}") from None
    moved = [k for k in ref if card[k] != off[k]
             and not (card[k] != card[k] and off[k] != off[k])]
    if moved:
        raise AssertionError(f"{label}: the battery is not bit-equal to "
                             f"itself with TF32 off: " + ", ".join(
                                 f"{k} {card[k]!r} != {off[k]!r}"
                                 for k in moved[:6]))
    return worst, steps


# the face nets on the card against the CPU: |Δ| / (1 + |x|) of every
# output (presence, box, landmarks, identity embeddings), both f32
FACE_NET_TOL = 1e-5
FACE_SIGNALS = ("face_topology_drift", "face_embedding_drift",
                "face_track_drift")


def face_vs_cpu(label, rep, clip, dev):
    """The face trio of a video report on the card against the port's on
    the CPU for the same frames. The landmark net's outputs (the coarse 64
    px pass and the refinement pass, as detect_landmarks_batch runs them)
    and the identity net's embeddings of the CPU's crops by FACE_NET_TOL;
    a presence on the other side of 0 within it, or a refinement crop
    corner (face.refine_corners of the two runs' boxes) a pixel apart, is
    a step, and that frame's refinement is not compared. The landmarks in
    px by 1e-2 px on the frames without a step. The three signals: the
    report's equal to the card's face_temporal_signals bit for bit, and
    the card's against the CPU's by the goldens' rule; after a step, the
    CPU's trio from the card's landmarks instead. Returns (the nets' worst
    |Δ| / (1 + |x|), the landmarks' worst |Δ| px, the steps)."""
    import numpy as np
    from tpudf_torch.models import face_landmark
    from tpudf_torch.serve import face

    frames = list(clip)
    h, w = clip.shape[1:3]
    orig = face_landmark.landmark_forward
    runs = {}
    for d in (dev, "cpu"):
        outs = []

        def spy(params, x):
            out = orig(params, x)
            outs.append({k: v.cpu().double().numpy() for k, v in out.items()})
            return out
        lm = face.get_landmark_params(d)
        face_landmark.landmark_forward = spy
        try:
            found = face.detect_landmarks_batch(clip, lm)
        finally:
            face_landmark.landmark_forward = orig
        sig = face.face_temporal_signals(frames, None, lm, device=d)
        runs[d] = (outs, found, sig)
    (card_out, card_lms, card_sig), (cpu_out, cpu_lms, cpu_sig) = (
        runs[dev], runs["cpu"])
    errors, steps, worst = [], [], 0.0

    def net(name, a, b, rows=None):
        nonlocal worst
        d = np.abs(a - b) / (1.0 + np.abs(b))
        if rows is not None:
            d = d[rows]
        m = float(d.max()) if d.size else 0.0
        worst = max(worst, m)
        if m > FACE_NET_TOL:
            errors.append(f"{name} |Δ|/(1+|x|) {m:.3e}")

    coarse_c, coarse_r = card_out[0], cpu_out[0]
    for k in coarse_r:
        net(f"landmark net {k}", coarse_c[k], coarse_r[k])
    pres_c, pres_r = coarse_c["presence"], coarse_r["presence"]
    face_c, face_r = pres_c > 0, pres_r > 0
    for i in np.flatnonzero(face_c != face_r):
        steps.append(f"frame {i} presence {pres_c[i]:.3e} / {pres_r[i]:.3e}")
    corners = {i: (face.refine_corners(coarse_c["box"][i], w, h),
                   face.refine_corners(coarse_r["box"][i], w, h))
               for i in np.flatnonzero(face_c & face_r)}
    for i, (a, b) in corners.items():
        if a != b:
            if max(abs(p - q) for p, q in zip(a, b)) > 1:
                errors.append(f"frame {i} refinement crop {a} != {b}")
            steps.append(f"frame {i} refinement crop {a} / {b}")
    same = [i for i, (a, b) in corners.items() if a == b]
    if len(cpu_out) > 1 and same and all(face_c == face_r):
        # the refinement pass's rows are the frames with a face, in order
        rows = np.searchsorted(np.flatnonzero(face_r), same)
        for k in cpu_out[1]:
            net(f"refinement {k}", card_out[1][k], cpu_out[1][k], rows)
    px = 0.0
    lc, lr = card_lms[0], cpu_lms[0]
    for i in same:
        if lc[i] is not None and lr[i] is not None:
            px = max(px, float(np.abs(lc[i] - lr[i]).max()))
    if px > 1e-2:
        errors.append(f"landmarks |Δ| {px:.3e} px")
    if any(l is not None for l in lr):
        crops = np.stack([face.face_crop_from_landmarks(f, l, out_size=112)
                          for f, l in zip(frames, lr) if l is not None])
        emb = {d: face.identity_embed_crops(face.get_face_embed_params(d),
                                            crops) for d in (dev, "cpu")}
        net("identity net", emb[dev], emb["cpu"])
    if errors:
        raise AssertionError(f"{label}: the face nets on the card vs the "
                             f"CPU: " + "; ".join(errors[:8]))
    for k in FACE_SIGNALS:
        got = rep["temporal_signals"].get(k)
        if got != card_sig[k]:
            raise AssertionError(f"{label}: the report's {k} {got!r} != the "
                                 f"card's face trio {card_sig[k]!r}")
    ref = cpu_sig
    if steps:
        orig_detect = face.detect_landmarks_batch
        face.detect_landmarks_batch = lambda f, p: card_lms
        try:
            ref = face.face_temporal_signals(
                frames, None, face.get_landmark_params("cpu"), device="cpu")
        finally:
            face.detect_landmarks_batch = orig_detect
    atol, rtol = REPORT_GOLDEN
    for k in FACE_SIGNALS:
        a, b = card_sig[k], ref[k]
        if (a is None) != (b is None) or (
                a is not None and abs(a - b) > atol + rtol * abs(b)):
            raise AssertionError(f"{label}: the card's {k} {a!r} vs the "
                                 f"CPU's {b!r}" + (" (from the card's "
                                                   "landmarks)" if steps
                                                   else ""))
    return worst, px, steps


def embeds_vs(label, eng, tw, frames):
    """embed_batch of (N, h, w, 3) uint8 frames (padded to a power-of-2
    bucket) with the kernels against the twins: rows of unit norm
    (|‖e‖ - 1| <= 1e-5), cosine >= 0.99 (the pooled rule). Returns the
    smallest cosine."""
    import numpy as np
    got, ref = eng.embed_batch(frames), tw.embed_batch(frames)
    if got.shape != (len(frames), eng.cfg.width):
        raise AssertionError(f"{label}: embed_batch shape {got.shape}")
    norm = np.abs(np.linalg.norm(got, axis=1) - 1.0).max()
    cos = float((got * ref).sum(1).min())
    if not np.isfinite(got).all() or norm > 1e-5 or cos < 0.99:
        raise AssertionError(f"{label}: embed_batch |‖e‖ - 1| {norm:.3e}, "
                             f"cosine {cos:.6f}")
    return cos


def video_request(label, eng, tw, clip, w8a8, expect, layers, e, dev,
                  tower_face=False):
    """One video request with the launch counts set to 0 just before it:
    exact launches (`video_expect`), id_drift present, the face trio
    computed where the clip has a face on 3 frames or more; then the
    twins' request and `video_vs`. Returns (report, launches, |Δ| tower,
    ties, chosen frame's comparison, face branch)."""
    import torch
    from tpudf_torch.core.backend import LAUNCHES
    from tpudf_torch.serve.report import predict_video
    branch, n_faces = face_branch(clip, dev)
    LAUNCHES.reset()
    rep = report_plain(predict_video(eng, clip))
    launches = LAUNCHES.snapshot()
    escalations = int(rep["chosen_frame_report"]["face_p_fake"] is not None)
    towers = 1 + int(tower_face and n_faces >= 3)
    check_launches(f"{label} T={len(clip)}", launches,
                   video_expect(expect, layers, e, towers, escalations))
    sig = rep["temporal_signals"]
    trio = [sig.get(k) for k in ("face_topology_drift",
                                 "face_embedding_drift", "face_track_drift")]
    if "id_drift" not in sig or (n_faces >= 3) != all(
            v is not None for v in trio):
        raise AssertionError(f"{label}: id_drift / face trio missing "
                             f"({branch} found {n_faces} faces: {trio})")
    if not 0.0 <= rep["video_prob"] <= 1.0 or len(rep["frame_probs"]) != len(
            clip) or len(rep["chosen_frame_report"]) < 80:
        raise AssertionError(f"{label}: report out of shape")
    LAUNCHES.reset()
    ref = report_plain(predict_video(tw, clip))
    torch.cuda.synchronize()
    if LAUNCHES.snapshot():
        raise AssertionError(f"{label}: twins launched "
                             f"{LAUNCHES.snapshot()}")
    from tpudf_torch.serve.report import predict_images
    d, ties, chosen = video_vs(
        label, rep, ref, w8a8, tower_face, lambda: tuple(
            report_plain(predict_images(m, clip, fast=True))
            for m in (eng, tw)))
    return rep, launches, d, ties, chosen, (branch, n_faces)


def sampler_file(path, n, size, cut, seed):
    """An mp4v clip of n size x size frames written by cv2: the golden
    recipe rolled 2 px a frame, another image from frame `cut` on."""
    import cv2
    frames = video_clip(n, size, seed, cut)
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25.0,
                        (size, size))
    if not w.isOpened():
        raise AssertionError("cv2 cannot open an mp4v writer")
    for f in frames:
        w.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    w.release()


def video_paths(dev, card, backbones):
    """`_video_paths` with cuDNN's TF32 at PyTorch's default (on): the
    battery must keep its convolutions in f32 itself."""
    import torch
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        return _video_paths(dev, card, backbones)
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class tf32_on:
    """A planted fault: TF32 on for cuDNN and cuBLAS, and each module's
    f32_math a no-op, until the block ends."""

    def __init__(self, *modules):
        self.modules = modules

    def __enter__(self):
        import contextlib
        import torch
        self.prev = (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32)
        self.orig = [m.f32_math for m in self.modules]
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        for m in self.modules:
            m.f32_math = contextlib.nullcontext

    def __exit__(self, *exc):
        import torch
        for m, f in zip(self.modules, self.orig):
            m.f32_math = f
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = self.prev


def _video_paths(dev, card, backbones):
    """Phase 3v: the video report at full width on phase 3r's engines.
    For each backbone and engine a request of VIDEO_T frames
    (`video_request`) and `embeds_vs` on three of them; the battery on the
    card against the CPU's once per clip; base-256 also on a clip with a
    scene cut at VIDEO_CUT, and engine B once with TPUDF_FACE_ID_EMBED=0
    (the face trio embeds through embed_batch); the battery launched
    under torch's sync check set to raise; planted faults that the checks
    must catch; the sampler (data/video.sample_video) on an mp4v file that
    cv2 writes, its frames through predict_video. Returns what phase 4
    times."""
    import dataclasses

    import numpy as np
    import torch
    from tpudf_torch.data import video, video_native
    from tpudf_torch.ops import flow, forensics
    from tpudf_torch.ops.routes import TWINS
    from tpudf_torch.serve import engine as engine_mod
    from tpudf_torch.serve import face, report
    from tpudf_torch.serve.engine import to_device

    print(f"phase 3v: the video report (predict_video: fast batch, temporal "
          f"battery, face trio, chosen frame) at base-256 and large-384, "
          f"{VIDEO_T} frames", flush=True)
    state = {"requests": {}}
    for name, (engines, expect, _) in backbones.items():
        size = engines["A"].cfg.image_size
        layers = engines["A"].cfg.layers
        clips = {"moving": video_clip(VIDEO_T, size, seed=40)}
        if name == "base-256":
            clips["cut"] = video_clip(VIDEO_T, size, seed=40, cut=VIDEO_CUT)
        state["requests"][name] = (engines, clips["moving"])
        for e, eng in engines.items():
            tw = dataclasses.replace(eng, kernels=TWINS)
            for cname, clip in clips.items():
                if cname == "cut" and e == "B":
                    continue
                label = f"video {name} engine {e} {cname}"
                rep, launched, d, ties, chosen, (branch, n) = video_request(
                    label, eng, tw, clip, e == "B", expect, layers, e, dev)
                cos = embeds_vs(label, eng, tw, clip[:3])
                sig = rep["temporal_signals"]
                print(f"{label} T={len(clip)}: launches {launched}; vs "
                      f"twins: battery bit-equal, max|Δ| tower {d:.3e}, "
                      f"chosen frame "
                      + (f"core {chosen[0]:.3e} battery {chosen[1]:.3e}"
                         if chosen else "differs (a tie)")
                      + f"; ties {ties or 'none'}; {rep['video_label']} "
                      f"p {rep['video_prob']:.4f} sora "
                      f"{rep['sora_likelihood']:.4f} id_drift "
                      f"{sig['id_drift']:.4f}; face: {branch} on {n} of "
                      f"{len(clip)} frames; embed_batch of 3 (bucket 4) "
                      f"cosine {cos:.6f} [{card}]", flush=True)
                if e == "A":
                    w, steps = video_battery_vs_cpu(label, rep, clip, dev)
                    print(f"  battery on the card vs the CPU: max|Δ| "
                          f"{w:.3e} (goldens' rule); steps at thresholds "
                          f"shown: " + (", ".join(
                              f"{k} |Δ| {v:.3e}" for k, v in steps.items())
                              or "none") + f" [{card}]", flush=True)
                    w, px, steps = face_vs_cpu(label, rep, clip, dev)
                    print(f"  face nets on the card vs the CPU: max|Δ|/(1+"
                          f"|x|) {w:.3e} (limit {FACE_NET_TOL}), landmarks "
                          f"max|Δ| {px:.3e} px; trio " + ", ".join(
                              f"{k} {rep['temporal_signals'].get(k)}"
                              for k in FACE_SIGNALS)
                          + f"; steps: {steps or 'none'} [{card}]",
                          flush=True)
                torch.cuda.empty_cache()

    # ---- the face trio through embed_batch (the identity net off)
    engines, expect, _ = backbones["base-256"]
    eng_b = engines["B"]
    tw_b = dataclasses.replace(eng_b, kernels=TWINS)
    clip = state["requests"]["base-256"][1]
    os.environ["TPUDF_FACE_ID_EMBED"] = "0"
    try:
        label = "video base-256 engine B, the face trio on embed_batch"
        rep, launched, d, ties, chosen, (branch, n) = video_request(
            label, eng_b, tw_b, clip, True, expect, eng_b.cfg.layers, "B",
            dev, tower_face=True)
    finally:
        os.environ.pop("TPUDF_FACE_ID_EMBED")
    print(f"{label}: launches {launched} ({'one more tower forward' if n >= 3 else 'no face: no embed_batch'}); "
          f"max|Δ| tower {d:.3e}; face_embedding_drift "
          f"{rep['temporal_signals'].get('face_embedding_drift')} ({branch} "
          f"on {n} frames) [{card}]", flush=True)

    # ---- the battery launches without a sync: torch's sync check set to
    # raise around the fast batch and the battery, each engine, warm
    for name, (engines, clip) in state["requests"].items():
        for e, eng in engines.items():
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                report.dispatch_images(eng, clip, True)
                fn, _ = report._video_temporal_for(eng, clip, True)
                fn(to_device(clip, eng.device))
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
    print("  the fast batch and the battery launched with no sync (torch's "
          "sync check raising) at both backbones, engines A and B",
          flush=True)

    # ---- planted faults: each must fail the checks above
    eng_a = backbones["base-256"][0]["A"]
    clip_a = state["requests"]["base-256"][1]
    large_engines, large_clip = state["requests"]["large-384"]

    def fault_fb_sign():
        orig = flow.dense_flow

        def flipped(a, b, **kw):
            u, v = orig(a, b, **kw)
            n = u.shape[0] // 2
            return (torch.cat([u[:n], -u[n:]]), torch.cat([v[:n], -v[n:]]))
        flow.dense_flow = flipped
        try:
            rep = report_plain(report.predict_video(eng_a, clip_a))
        finally:
            flow.dense_flow = orig
        video_battery_vs_cpu("fault", rep, clip_a, dev)

    def fault_unresized():
        orig = report.resize
        report.resize = lambda x, shape, method, antialias=True: x
        try:
            rep = report_plain(report.predict_video(large_engines["A"],
                                                    large_clip))
        finally:
            report.resize = orig
        video_battery_vs_cpu("fault", rep, large_clip, dev)

    def fault_unnormalised():
        eng = large_engines["B"]
        orig = engine_mod._unit_rows
        engine_mod._unit_rows = lambda f: f
        try:
            embeds_vs("fault", eng, dataclasses.replace(eng, kernels=TWINS),
                      large_clip[:3])
        finally:
            engine_mod._unit_rows = orig

    def fault_tf32():
        with tf32_on(forensics, report, face):
            rep = report_plain(report.predict_video(eng_a, clip_a))
        video_battery_vs_cpu("fault", rep, clip_a, dev)

    def fault_tf32_face():
        with tf32_on(face):
            rep = report_plain(report.predict_video(eng_a, clip_a))
            face_vs_cpu("fault", rep, clip_a, dev)

    for fault in (fault_fb_sign, fault_unresized, fault_unnormalised,
                  fault_tf32, fault_tf32_face):
        try:
            fault()
        except AssertionError as err:
            print(f"  planted fault {fault.__name__[6:]}: caught "
                  f"({str(err)[:160]})", flush=True)
            continue
        raise AssertionError(f"video: the checks miss the planted fault "
                             f"{fault.__name__[6:]}")

    # ---- the sampler: an mp4v file written by cv2, sampled, reported
    native = video_native.available()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "clip.mp4")
        sampler_file(path, 90, 288, 45, seed=50)
        frames, idxs = video.sample_video(path)
        cv_frames, cv_idxs = video.sample_video(path, prefer_native=False)
    if cv_frames is None or len(cv_idxs) < 3:
        raise AssertionError(f"sampler: cv2 read {cv_idxs}")
    if frames is None or (not native and (
            idxs != cv_idxs or not np.array_equal(frames, cv_frames))):
        raise AssertionError(f"sampler: {idxs} != cv2's {cv_idxs}")
    label = "video base-256 engine A, sampled from the file"
    rep = report_plain(report.predict_video(eng_a, frames))
    if len(rep["frame_probs"]) != len(idxs) or "id_drift" not in rep[
            "temporal_signals"]:
        raise AssertionError(f"{label}: report out of shape")
    print(f"  sampler: route {'native (cpp/libtpudf_video.so)' if native else 'cv2 (the native library does not load here)'}; "
          f"{len(idxs)} frames {idxs} of a 90-frame mp4v file with a cut "
          f"at 45; {label}: {rep['video_label']} p {rep['video_prob']:.4f} "
          f"[{card}]", flush=True)
    return state


def video_timings(state, card):
    """Phase 4: each video request of phase 3v by the host clock (warm),
    and its parts each alone: the frames' fast batch (dispatch_images),
    the battery (its embeddings included), the face trio (host and
    device) and the chosen frame's full request, each by CUDA events
    around calls that end in their own device→host copy where they have
    one (2 calls each after one warm-up: their spread is a few %; the
    request 3 by the host clock). A profile of base-256 engine A's request
    gives the device's idle share."""
    import torch
    from tpudf_torch.serve import face, report
    from tpudf_torch.serve.engine import to_device

    for name, (engines, clip) in state["requests"].items():
        for e, eng in engines.items():
            run = lambda: report.predict_video(eng, clip)
            rep = run()
            torch.cuda.synchronize()
            iters = 3
            t0 = time.perf_counter()
            for _ in range(iters):
                run()
            total = (time.perf_counter() - t0) / iters * 1e3
            iters = 2
            fast_ms = cuda_ms(lambda: report.dispatch_images(eng, clip, True),
                              iters=iters, warmup=1)
            fn, _ = report._video_temporal_for(eng, clip, True)
            dclip = to_device(clip, eng.device)
            battery_ms = cuda_ms(lambda: fn(dclip), iters=iters, warmup=1)
            lm = face.get_landmark_params(eng.device)
            face_ms = cuda_ms(lambda: face.face_temporal_signals(
                list(clip), eng.embed_batch, lm_params=lm,
                device=eng.device), iters=iters, warmup=1)
            c = rep["chosen_frame"]
            chosen_ms = cuda_ms(lambda: report.predict_images(
                eng, clip[c:c + 1], fast=False), iters=iters, warmup=1)
            print(f"video {name} engine {e} T={len(clip)}: request "
                  f"{total:.3f} ms (host clock); alone (CUDA events): fast "
                  f"batch {fast_ms:.3f} ms, battery {battery_ms:.3f}, face "
                  f"trio {face_ms:.3f}, chosen frame's full request "
                  f"{chosen_ms:.3f} [{card}]", flush=True)
            if (name, e) == ("base-256", "A"):
                profile(run, f"video {name} engine {e} T={len(clip)}", card,
                        iters=2, top=10)
            torch.cuda.empty_cache()


# The front doors (phases 3i and 3u, `cli_paths` and `app_paths`): the
# inference CLI (tpudf_torch.cli.infer.main) at base-256 with --int8
# --tome_r --patch_tome on a seeded folder of CLI_IMAGES JPEG and PNG
# images of CLI_SIZE px (and the same list as a CSV), and the app's
# callbacks, the forensic maps and the forensics CLI on the CLI's engine.
# Each CLI request is held to phase 3r's launches (the counts set to 0
# just before it), its pixels to `_decode_image`'s, its JSONL reports to
# the same engine's fresh request on those pixels and to the twins' by
# phase 3r's rules (`report_vs`; a request is not bit-repeatable: ToMe's
# merge and K2's Σout² add with f32 atomics); the few-shot probes trained
# on the card to the same probes on the CPU: predictions within
# FEW_SHOT_TOL (the CPU test's tolerance), the fitted parameters within
# FEW_SHOT_PARAM (a fifth of the kernel probe's Adam lr: the RBF matrix of
# 768-d unit features lies in [0.9987, 1], so the dual coefficients'
# directions off its near-constant rows get gradients at float noise,
# which Adam's normalised steps turn into moves of up to lr; they barely
# move a prediction); the maps on the card to the port's CPU run with TF32
# off by the battery's rule (a JPEG residual block a rounding step off
# allowed on MAP_JPEG_BLOCKS of them, within 1e-3), its images within 1
# (UINT8_SHARE of the values apart at most), but the panel's JPEG residual
# tile: a block a step off moves the whole normalised tile, so that tile
# is held to the port's coloring of the card's own map (`panel_vs`).
CLI_MODEL = "base-256"
CLI_IMAGES = 48
CLI_SIZE = 288
CLI_FULL = 8
CLI_CLIP = (30, 256)            # the --video clip's frames and side
FEW_SHOT_TOL = 1e-4
FEW_SHOT_PARAM = 1e-2
PANEL_JPEG_TILE = 4              # the panel's jpeg_residual tile
MAP_JPEG_BLOCKS = 2e-3
UINT8_SHARE = 5e-2


def cli_inputs(root):
    """The CLI's inputs under root: folder/{REAL,FAKE}/ of CLI_IMAGES seeded
    images (`report_images` at CLI_SIZE px: even ones PNG, odd ones JPEG
    at quality 90), all.csv (path, label: the folder's list), full.csv
    (the first CLI_FULL of it, both classes) and clips/clip.mp4 (an mp4v
    clip cv2 writes, `sampler_file`). Returns (folder, all.csv, full.csv,
    clips dir, the JPEG paths)."""
    import csv

    from PIL import Image
    folder = os.path.join(root, "folder")
    imgs = report_images(CLI_IMAGES, CLI_SIZE, seed=50)
    rows, jpegs = [], []
    for i, img in enumerate(imgs):
        cls = "FAKE" if i % 4 >= 2 else "REAL"
        os.makedirs(os.path.join(folder, cls), exist_ok=True)
        path = os.path.join(folder, cls, f"{i:03d}.{'jpg' if i % 2 else 'png'}")
        Image.fromarray(img).save(path, **({"quality": 90} if i % 2 else {}))
        rows.append((path, int(cls == "FAKE")))
        if i % 2:
            jpegs.append(path)
    for name, part in (("all.csv", rows), ("full.csv", rows[:CLI_FULL])):
        with open(os.path.join(root, name), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["path", "label"])
            w.writerows(part)
    clips = os.path.join(root, "clips")
    os.makedirs(clips)
    sampler_file(os.path.join(clips, "clip.mp4"), *CLI_CLIP, None, seed=51)
    return (folder, os.path.join(root, "all.csv"),
            os.path.join(root, "full.csv"), clips, jpegs)


def cli_run(argv, fault=None, engine=None):
    """tpudf_torch.cli.infer.main(argv) with its calls recorded: the engine
    it builds (or `engine`, given in its place), each predict_images /
    predict_video / embed_batch call's pixels, result, launches (the counts
    set to 0 just before it, read just after) and host ms, the few-shot
    probes' inputs and outputs; `fault(engine)` plants a fault in the
    engine and returns its undo. Returns the record."""
    import numpy as np
    import torch
    from tpudf_torch.cli import infer
    from tpudf_torch.core.backend import LAUNCHES

    rec = {"engine": None, "images": [], "videos": [], "embeds": [],
           "probes": [], "build_s": 0.0}
    names = ("build_engine", "predict_images", "predict_video",
             "train_linear_probe", "linear_probe_predict",
             "train_kernel_probe", "kernel_probe_predict")
    orig = {k: getattr(infer, k) for k in names}
    undo = []

    def build_engine(args, calib=None):
        t0 = time.perf_counter()
        eng = engine if engine is not None else orig["build_engine"](args,
                                                                     calib)
        torch.cuda.synchronize()
        rec["build_s"] = time.perf_counter() - t0
        rec["engine"] = eng
        embed = eng.embed_batch

        def embed_batch(px, pad=True):
            LAUNCHES.reset()
            out = embed(px, pad)
            rec["embeds"].append((np.array(px), LAUNCHES.snapshot()))
            return out
        eng.embed_batch = embed_batch
        undo.append(lambda: delattr(eng, "embed_batch"))
        if fault is not None:
            undo.append(fault(eng))
        return eng

    def timed(kind, fn):
        def call(eng, px, **kw):
            torch.cuda.synchronize()
            LAUNCHES.reset()
            t0 = time.perf_counter()
            out = fn(eng, px, **kw)
            ms = (time.perf_counter() - t0) * 1e3
            # a copy as JSON carries it, before the CLI adds its keys
            rec[kind].append((np.array(px), kw.get("fast", False),
                              report_plain(out), LAUNCHES.snapshot(), ms))
            return out
        return call

    def probe(name):
        def call(*args):
            out = orig[name](*args)
            rec["probes"].append((name, args, out))
            return out
        return call

    infer.build_engine = build_engine
    infer.predict_images = timed("images", orig["predict_images"])
    infer.predict_video = timed("videos", orig["predict_video"])
    for k in names[3:]:
        setattr(infer, k, probe(k))
    t0 = time.perf_counter()
    try:
        infer.main(argv)
        torch.cuda.synchronize()
    finally:
        rec["main_s"] = time.perf_counter() - t0
        for k, v in orig.items():
            setattr(infer, k, v)
        for u in reversed(undo):
            u()
    return rec


def cli_jsonl(path):
    """The CLI's JSONL reports, each without "path" and "inverted", and
    their paths."""
    reps, paths = [], []
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            paths.append(r.pop("path"))
            r.pop("inverted", None)
            reps.append(r)
    return reps, paths


def cli_vs(label, rec, out, expect, twin_images=None):
    """A CLI image run's checks (see above): each request's launches
    `expect[mode]`, each embed_batch's one tower forward without ToMe; its
    pixels `_decode_image`'s of its paths; the JSONL the requests' reports
    in order; a fresh request of the same engine on those pixels and the
    twins' (first `twin_images` of each request, all by default) by
    `report_vs`. Returns (n images, worst |Δ| fresh (core, battery), worst
    |Δ| twins (core, battery), ties)."""
    import dataclasses

    import numpy as np
    from tpudf_torch.data.datasets import _decode_image
    from tpudf_torch.ops.routes import TWINS
    from tpudf_torch.serve.report import predict_images

    eng = rec["engine"]
    tw = dataclasses.replace(eng, kernels=TWINS)
    size, layers = eng.cfg.image_size, eng.cfg.layers
    reps, paths = cli_jsonl(out)
    fresh_d, twin_d, ties, i = [0.0, 0.0], [0.0, 0.0], [], 0
    for j, (px, fast, got, launched, _) in enumerate(rec["images"]):
        n = len(px)
        check_launches(f"{label} request {j} B={n}", launched,
                       expect["fast" if fast else "full"])
        want_px = np.stack([_decode_image(p, size) for p in paths[i:i + n]])
        if not np.array_equal(px, want_px):
            raise AssertionError(
                f"{label} request {j}: its pixels are not _decode_image's of "
                f"its paths ({(px != want_px).mean():.4f} of them differ)")
        if got != reps[i:i + n]:
            raise AssertionError(f"{label} request {j}: the JSONL is not "
                                 f"the request's reports")
        fresh = report_plain(predict_images(eng, want_px, fast=fast))
        core, batt, t = report_vs(f"{label} request {j} vs a fresh one", got,
                                  fresh, True, eng.gbdt)
        fresh_d = [max(fresh_d[0], core), max(fresh_d[1], batt)]
        ties += t
        k = twin_images or n
        ref = report_plain(predict_images(tw, want_px[:k], fast=fast))
        core, batt, t = report_vs(f"{label} request {j} vs twins", got[:k],
                                  ref, True, eng.gbdt)
        twin_d = [max(twin_d[0], core), max(twin_d[1], batt)]
        ties += t
        i += n
    if i != len(reps):
        raise AssertionError(f"{label}: {len(reps)} JSONL lines, {i} "
                             f"images requested")
    for px, launched in rec["embeds"]:
        check_launches(f"{label} embed_batch B={len(px)}", launched,
                       tower_expect(layers, "B"))
    return i, fresh_d, twin_d, ties


def few_shot_vs(label, rec, dev):
    """The probes cli.infer trained and applied on `dev` against the same
    calls on the CPU (the same features, moved): predictions within
    FEW_SHOT_TOL, the fitted parameters within FEW_SHOT_PARAM. Returns the
    worst |Δ| of (the parameters, the predictions)."""
    import torch
    from tpudf_torch.serve import adapt

    cpu = lambda t: t.cpu() if torch.is_tensor(t) else t
    worst, trained = {"params": 0.0, "preds": 0.0}, {}
    for name, args, out in rec["probes"]:
        if name.startswith("train"):
            ref = getattr(adapt, name)(*map(cpu, args))
            trained[id(out)] = ref
            kind, pairs = "params", [(out[k], ref[k]) for k in out
                                     if torch.is_tensor(out[k]) and k != "X"]
        else:
            ref = getattr(adapt, name)(trained[id(args[0])], cpu(args[1]))
            kind, pairs = "preds", [(out, ref)]
        for a, b in pairs:
            if a.device.type != dev.type:
                raise AssertionError(f"{label}: {name} ran on {a.device}")
            worst[kind] = max(worst[kind], float((a.cpu() - b).abs().max()))
    if (len(rec["probes"]) != 2 or worst["preds"] > FEW_SHOT_TOL
            or worst["params"] > FEW_SHOT_PARAM):
        raise AssertionError(f"{label}: the card's probes vs the CPU's: "
                             f"parameters {worst['params']:.3e} (limit "
                             f"{FEW_SHOT_PARAM}), predictions "
                             f"{worst['preds']:.3e} (limit {FEW_SHOT_TOL}); "
                             f"{len(rec['probes'])} calls")
    return worst["params"], worst["preds"]


def fault_fast_tail(eng):
    """Plant: the full path's tail reads the fast path's core columns (as
    phase 3r's fault). Returns the undo."""
    import torch
    from tpudf_torch.serve.engine import (_PACK_KEY, FAST_SCALARS,
                                          FULL_SCALARS)
    orig_dispatch = eng.dispatch_batch

    def dispatch(pixels, fast=False):
        core = dict(orig_dispatch(pixels, fast))
        packed = core[_PACK_KEY]
        cols = [packed[:, FAST_SCALARS.index(k)] if k in FAST_SCALARS
                else packed[:, i] for i, k in enumerate(FULL_SCALARS)]
        core[_PACK_KEY] = torch.cat(
            [torch.stack(cols, 1), packed[:, len(FULL_SCALARS):]], 1)
        return core
    eng.dispatch_batch = dispatch
    return lambda: delattr(eng, "dispatch_batch")


def cli_paths(dev, card, tmp):
    """Phase 3i: the inference CLI at full width on the card (base-256,
    --int8 --tome_r --patch_tome, --device cuda): `main` four times (fast
    with --labels_from_dirs --calibrate --few_shot linear on the folder;
    full on CLI_FULL images; --few_shot kernel on the CSV; --video on the
    clip), each held by `cli_vs` (the video: its frames the sampler's, its
    launches `video_expect`, its report against a fresh request and the
    twins' by `video_vs`) and the probes by `few_shot_vs`; the decode route
    of the JPEGs printed; planted faults that the checks must catch: the
    CLI's decode forced to PIL (where the native library loads) and the
    full path's tail reading the fast core's columns. Returns what phase
    3u and phase 4 use."""
    import collections as col
    import dataclasses

    import numpy as np
    from tpudf_torch.data import datasets, decode
    from tpudf_torch.data.video import sample_video
    from tpudf_torch.models.siglip import CONFIGS
    from tpudf_torch.ops.routes import TWINS
    from tpudf_torch.serve.report import predict_images, predict_video

    cfg = CONFIGS[CLI_MODEL]
    size, layers = cfg.image_size, cfg.layers
    print(f"phase 3i: the inference CLI (tpudf_torch.cli.infer.main) at "
          f"{CLI_MODEL}, --int8 --tome_r --patch_tome --device {dev}",
          flush=True)
    folder, all_csv, full_csv, clips, jpegs = cli_inputs(tmp)
    native = decode.available() and all(
        decode.decode_resize(p, size) is not None for p in jpegs)
    print(f"  decode route of the {len(jpegs)} JPEGs: "
          f"{'native (cpp/libtpudf_decode.so)' if native else 'PIL (cpp/libtpudf_decode.so does not load)'}"
          f"; the {CLI_IMAGES - len(jpegs)} PNGs: PIL", flush=True)
    base = ["--model_size", CLI_MODEL, "--int8", "--tome_r", "--patch_tome",
            "--device", str(dev)]
    expect = {m: v for (e, m), v in engine_expect(
        layers, cfg.num_patches).items() if e == "B"}
    out = lambda name: os.path.join(tmp, f"{name}.jsonl")
    state = {"runs": {}}

    def report(label, rec, n, fresh, twin, ties, extra=""):
        ms = sum(r[4] for r in rec["images"])
        print(f"  {label}: {n} images, {len(rec['images'])} requests "
              f"(launches {rec['images'][0][3]} each, phase 3r's), "
              f"{len(rec['embeds'])} embed_batch; main {rec['main_s']:.3f} s "
              f"(engine build {rec['build_s']:.3f} s), requests {ms:.3f} ms: "
              f"{n / (rec['main_s'] - rec['build_s']):.1f} img/s end to end "
              f"past the build, {n * 1e3 / ms:.1f} img/s in requests; vs a "
              f"fresh request max|Δ| core {fresh[0]:.3e}, battery "
              f"{fresh[1]:.3e}; vs twins core {twin[0]:.3e}, battery "
              f"{twin[1]:.3e}; ties {ties or 'none'}{extra} [{card}]",
              flush=True)

    # 1. fast, labels from the folder, calibration, the linear probe
    rec = cli_run(["--input", folder, "--out", out("fast")] + base
                  + ["--fast", "--labels_from_dirs", "--calibrate",
                     "--few_shot", "linear"])
    n, fresh, twin, ties = cli_vs("cli fast", rec, out("fast"), expect, 8)
    probe = few_shot_vs("cli fast", rec, dev)
    report("cli --fast --labels_from_dirs --calibrate --few_shot linear",
           rec, n, fresh, twin, ties, f"; linear probe card vs CPU: "
           f"parameters {probe[0]:.3e}, predictions {probe[1]:.3e}")
    state["runs"]["fast"] = rec
    eng = rec["engine"]

    # 2. full on CLI_FULL images
    rec = cli_run(["--input", full_csv, "--out", out("full")] + base
                  + ["--batch_size", str(CLI_FULL)])
    n, fresh, twin, ties = cli_vs("cli full", rec, out("full"), expect)
    labels = col.Counter(r["final_label"] for r in cli_jsonl(out("full"))[0])
    report(f"cli full on {CLI_FULL}", rec, n, fresh, twin, ties,
           f"; labels {dict(labels)}")
    state["runs"]["full"] = rec

    # 3. the kernel probe on the CSV
    rec = cli_run(["--input", all_csv, "--out", out("kernel")] + base
                  + ["--fast", "--few_shot", "kernel"])
    n, fresh, twin, ties = cli_vs("cli kernel", rec, out("kernel"), expect,
                                  8)
    probe = few_shot_vs("cli kernel", rec, dev)
    report("cli --fast --few_shot kernel on the CSV", rec, n, fresh, twin,
           ties, f"; kernel probe card vs CPU: parameters {probe[0]:.3e}, "
           f"predictions {probe[1]:.3e}")

    # 4. --video on the clip
    rec = cli_run(["--input", clips, "--out", out("video")] + base
                  + ["--video"])
    (frames, _, got, launched, ms), = rec["videos"]
    reps, paths = cli_jsonl(out("video"))
    want_frames, _ = sample_video(paths[0], size=size)
    if not np.array_equal(frames, want_frames):
        raise AssertionError("cli video: its frames are not sample_video's")
    if reps != [got]:
        raise AssertionError("cli video: the JSONL is not the request's")
    v_eng = rec["engine"]
    escalations = int(got["chosen_frame_report"]["face_p_fake"] is not None)
    check_launches("cli video", launched, video_expect(
        {("B", k): v for k, v in expect.items()}, layers, "B", 1,
        escalations))
    tw_v = dataclasses.replace(v_eng, kernels=TWINS)
    frames_fn = lambda: tuple(report_plain(predict_images(
        m, frames, fast=True)) for m in (v_eng, tw_v))
    fresh = report_plain(predict_video(v_eng, frames))
    d_f, ties_f, _ = video_vs("cli video vs a fresh request", got, fresh,
                              True, False, frames_fn)
    d_t, ties_t, _ = video_vs("cli video vs twins", got, report_plain(
        predict_video(tw_v, frames)), True, False, frames_fn)
    print(f"  cli --video: {len(frames)} frames sampled (cv2 route), "
          f"launches {launched}; main {rec['main_s']:.3f} s (engine build "
          f"{rec['build_s']:.3f} s), the clip's request {ms:.3f} ms; vs a "
          f"fresh request max|Δ| tower {d_f:.3e}, vs twins {d_t:.3e}; ties "
          f"{(ties_f + ties_t) or 'none'}; video_label "
          f"{got['video_label']} [{card}]", flush=True)
    state["video"] = (paths[0], frames)

    # planted faults, each on engine 1's build (no rebuild)
    def fault_pil_decode():
        orig = datasets.decode_resize
        datasets.decode_resize = lambda path, size: None
        try:
            rec = cli_run(["--input", full_csv, "--out", out("fault")]
                          + base + ["--batch_size", str(CLI_FULL)],
                          engine=eng)
        finally:
            datasets.decode_resize = orig
        cli_vs("fault", rec, out("fault"), expect, 2)

    def fault_fast_columns():
        rec = cli_run(["--input", full_csv, "--out", out("fault")] + base
                      + ["--batch_size", str(CLI_FULL)], engine=eng,
                      fault=fault_fast_tail)
        cli_vs("fault", rec, out("fault"), expect, 2)

    for fault, applies in ((fault_pil_decode, native),
                           (fault_fast_columns, True)):
        name = fault.__name__[6:]
        if not applies:
            print(f"  planted fault {name}: not applicable (the native "
                  f"decoder does not load: both routes are PIL's)",
                  flush=True)
            continue
        try:
            fault()
        except AssertionError as err:
            print(f"  planted fault {name}: caught ({str(err)[:160]})",
                  flush=True)
            continue
        raise AssertionError(f"cli: the checks miss the planted fault "
                             f"{name}")
    state["engine"] = eng
    return state


def uint8_vs(label, got, want):
    """uint8 images within 1 on every value, at most UINT8_SHARE apart.
    Returns the share apart."""
    import numpy as np
    d = np.abs(got.astype(int) - want.astype(int))
    if got.shape != want.shape or d.max() > 1 or (d > 0).mean() > UINT8_SHARE:
        raise AssertionError(f"{label}: uint8 max|Δ| {d.max()}, share apart "
                             f"{(d > 0).mean():.4f}")
    return float((d > 0).mean())


def panel_tiles(panel):
    """The nine 256 px tiles of `serve.app.forensic_panel_image`'s canvas,
    in order."""
    pad, title_h, cell = 4, 18, 256
    for i in range(9):
        r, c = divmod(i, 3)
        y = pad + r * (cell + title_h + pad) + title_h
        x = pad + c * (cell + pad)
        yield panel[y:y + cell, x:x + cell]


def panel_vs(label, got, want, img, dev):
    """A panel on `dev` against the CPU's: `uint8_vs` tile by tile and on
    the rest of the canvas, but the JPEG residual tile, which must equal
    the port's coloring on `dev` of its own JPEG residual map of `img`
    (that map held by `maps_vs`). Returns the largest share apart."""
    import numpy as np
    import torch
    from tpudf_torch.data.pipeline import resize
    from tpudf_torch.ops import forensic_maps
    from tpudf_torch.ops.forensics import f32_math
    g, w = got.copy(), want.copy()
    with f32_math():
        x = torch.from_numpy(img[None].copy()).to(dev).float() / 255.0
        if x.shape[1] != 256:
            x = resize(x, (1, 256, 256, 3), "bilinear")
        m = forensic_maps._norm01(forensic_maps.jpeg_residual_map(x))[0]
        tile = forensic_maps.jet_colors(np.clip(
            resize(m, (256, 256), "bilinear").cpu().numpy(), 0, 1))
    share = 0.0
    for i, (a, b) in enumerate(zip(panel_tiles(g), panel_tiles(w))):
        if i == PANEL_JPEG_TILE:
            if not np.array_equal(a, tile):
                raise AssertionError(f"{label}: the JPEG residual tile is "
                                     f"not the coloring of its map")
            a[...] = b
        else:
            share = max(share, uint8_vs(f"{label} tile {i}", a, b))
    return max(share, uint8_vs(label, g, w))


def maps_vs(label, got, want):
    """Maps on the card against the CPU's by the battery's rule (the JPEG
    residual map's on all but MAP_JPEG_BLOCKS of its blocks, those within
    1e-3). Returns the worst |Δ| within the rule."""
    atol, rtol = REPORT_GOLDEN
    worst = 0.0
    for k, w in want.items():
        g = got[k].cpu()
        d = (g - w).abs()
        off = d > atol + rtol * w.abs()
        if k == "jpeg_residual":
            if off.float().mean() > MAP_JPEG_BLOCKS or d.max() > 1e-3:
                raise AssertionError(f"{label} {k}: {off.float().mean():.4f}"
                                     f" of blocks off, max|Δ| {d.max():.3e}")
        elif off.any():
            raise AssertionError(f"{label} {k}: max|Δ| {d.max():.3e}")
        worst = max(worst, float(d[~off].max()) if (~off).any() else 0.0)
    return worst


def app_paths(dev, card, tmp, cli):
    """Phase 3u: the app (`serve.app.build_predict_fns` over phase 3i's
    base-256 W8A8 engine, as `serve.app.main` builds it through
    `cli.infer.build_engine`) and the forensics CLI on the card:
    predict_image on a PIL image (its request's launches phase 3r's, its
    report against a fresh predict_images of the same pixels by
    `report_vs`, its 9 payloads), predict_clip on phase 3i's clip (its
    report against a fresh predict_video, 10 payloads); the map battery at
    256 and 384 px, the overlay, the panel and the collage on the card
    against the port's CPU run of the same functions (`maps_vs`,
    `uint8_vs`), TF32 left on in the maps (a planted fault, reported);
    `cli.forensics` on a JPEG: its PNGs, and scores.json equal to
    forensic_battery on the card on the same pixels. Returns what phase 4
    times."""
    import contextlib
    import dataclasses

    import numpy as np
    import torch
    from PIL import Image
    from tpudf_torch.cli import forensics as forensics_cli
    from tpudf_torch.ops.routes import TWINS
    from tpudf_torch.core.backend import LAUNCHES
    from tpudf_torch.ops import forensic_maps
    from tpudf_torch.ops.forensics import _gray, forensic_battery
    from tpudf_torch.serve import app
    from tpudf_torch.serve.report import predict_images, predict_video

    print(f"phase 3u: the app's callbacks, the forensic maps and the "
          f"forensics CLI on the card ({CLI_MODEL} W8A8 engine)", flush=True)
    eng = cli["engine"]
    size = eng.cfg.image_size
    predict_image, predict_clip = app.build_predict_fns(eng)
    expect = engine_expect(eng.cfg.layers, eng.cfg.num_patches)[("B",
                                                                  "full")]
    src = report_images(5, 384, seed=52)[4]
    pil = Image.fromarray(src)
    LAUNCHES.reset()
    t0 = time.perf_counter()
    payload = predict_image(pil)
    torch.cuda.synchronize()
    image_ms = (time.perf_counter() - t0) * 1e3
    check_launches("app predict_image", LAUNCHES.snapshot(), expect)
    px = np.array(pil.convert("RGB").resize((size, size), Image.BICUBIC))
    got = json.loads(payload[7])
    core, batt, ties = report_vs("app predict_image vs a fresh request",
                                 [got], report_plain(predict_images(
                                     eng, px[None])), True)
    with open(payload[8]) as f:
        saved = json.load(f)
    if len(payload) != 9 or got != saved:
        raise AssertionError("app predict_image: payloads out of shape")
    os.unlink(payload[8])
    print(f"  predict_image ({src.shape[0]} px PIL → {size}): {image_ms:.3f} ms "
          f"(host clock, maps, panel and collage included), launches "
          f"{expect} (phase 3r's); report vs a fresh request max|Δ| core "
          f"{core:.3e}, battery {batt:.3e}; ties {ties or 'none'} [{card}]",
          flush=True)

    clip_path, frames = cli["video"]
    t0 = time.perf_counter()
    payload = predict_clip(clip_path)
    torch.cuda.synchronize()
    clip_ms = (time.perf_counter() - t0) * 1e3
    got = json.loads(payload[8])
    tw = dataclasses.replace(eng, kernels=TWINS)
    d, ties, _ = video_vs("app predict_clip vs a fresh request", got,
                          report_plain(predict_video(eng, frames)), True,
                          False, lambda: tuple(report_plain(predict_images(
                              m, frames, fast=True)) for m in (eng, tw)))
    if len(payload) != 10 or len(payload[6]) != len(frames):
        raise AssertionError("app predict_clip: payloads out of shape")
    os.unlink(payload[9])
    print(f"  predict_clip ({len(frames)} frames): {clip_ms:.3f} ms (host "
          f"clock, sampling included); report vs a fresh request max|Δ| "
          f"tower {d:.3e}; ties {ties or 'none'} [{card}]", flush=True)

    # the maps, overlay, panel and collage: the card vs the CPU
    def front(device, img):
        x = torch.from_numpy(img[None].copy()).to(device).float() / 255.0
        maps = forensic_maps.forensic_map_battery(x)
        return (maps, forensic_maps.heatmap_overlay(img, maps["combined"][0]),
                app.forensic_panel_image(img, device),
                app.jitter_collage(img, device=device))

    worst, shares = 0.0, []
    for size in (256, 384):
        img = report_images(3, size, seed=53 + size)[2]
        card_out, cpu_out = front(dev, img), front("cpu", img)
        worst = max(worst, maps_vs(f"maps {size}", card_out[0], cpu_out[0]))
        shares += [uint8_vs(f"overlay {size}", card_out[1], cpu_out[1]),
                   panel_vs(f"panel {size}", card_out[2], cpu_out[2], img,
                            dev),
                   uint8_vs(f"collage {size}", card_out[3], cpu_out[3])]
    print(f"  maps on the card vs the CPU (TF32 off) at 256 and 384 px: "
          f"max|Δ| {worst:.3e} (the battery's rule); overlay, panel (its "
          f"JPEG tile the coloring of the card's map), collage within 1, "
          f"share apart ≤ {max(shares):.5f} [{card}]",
          flush=True)

    def fault_tf32_maps():
        prev = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
        orig = forensic_maps.f32_math
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        forensic_maps.f32_math = contextlib.nullcontext
        try:
            img = report_images(3, 384, seed=437)[2]
            x = torch.from_numpy(img[None].copy()).float() / 255.0
            maps_vs("fault", forensic_maps.forensic_map_battery(x.to(dev)),
                    forensic_maps.forensic_map_battery(x))
        finally:
            forensic_maps.f32_math = orig
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = prev
    try:
        fault_tf32_maps()
        print("  planted fault tf32_maps: within the checks (reported, not "
              "required)", flush=True)
    except AssertionError as err:
        print(f"  planted fault tf32_maps: caught ({str(err)[:160]})",
              flush=True)

    # the forensics CLI on a JPEG
    jpeg = os.path.join(tmp, "forensics.jpg")
    Image.fromarray(report_images(3, 320, seed=54)[2]).save(jpeg, quality=90)
    out_dir = os.path.join(tmp, "ultra")
    t0 = time.perf_counter()
    forensics_cli.main([jpeg, "--out_dir", out_dir, "--device", str(dev)])
    torch.cuda.synchronize()
    cli_ms = (time.perf_counter() - t0) * 1e3
    with open(os.path.join(out_dir, "scores.json")) as f:
        scores = json.load(f)
    from tpudf_torch.data.media import load_image_any
    img256 = np.asarray(Image.fromarray(load_image_any(jpeg)).resize(
        (256, 256)), np.uint8)
    x = torch.from_numpy(img256[None].copy()).to(dev).float() / 255.0
    want = {k: float(v[0]) for k, v in forensic_battery(x).items()}
    pngs = sorted(f for f in os.listdir(out_dir) if f.endswith(".png"))
    if scores != want or pngs != sorted(f"{k}.png" for k in
                                        forensic_maps.forensic_map_battery(
                                            x, _gray(x))):
        raise AssertionError("cli.forensics: scores.json is not "
                             "forensic_battery's, or its PNGs are not the "
                             "maps'")
    print(f"  cli.forensics on a 320 px JPEG: {len(pngs)} PNGs, "
          f"scores.json equal to forensic_battery's on the card "
          f"({len(scores)} scores); {cli_ms:.3f} ms (host clock) "
          f"[{card}]", flush=True)
    return {"image_ms": image_ms, "clip_ms": clip_ms, "pil": pil,
            "clip": clip_path}


# Phase 3s (`sid_paths`): the MTL CLI's default route, SID_Set through the
# Hugging Face `datasets` package, served by a stand-in module of seeded
# in-memory records (no network, and the card's machine has no `datasets`)
SID_MODEL = "base-256"          # a test config rehearses phase 3s on the CPU
SID_TAPS = (2, 6, 10, -1)       # the CLI's default (a test config's: (0, -1))
SID_RECORDS = {"train": 48, "validation": 32}
SID_SOURCE = 512                # the records' side: BICUBIC / NEAREST to 256
# every schema variant the mapping takes, cycled over the records: (image
# encoding, mask encoding, label, the class it maps to)
SID_VARIANTS = [
    ("pil", "rgb255", 2, 2), ("bytes", "gray", 0, 0),
    ("path", "float01", "tampered", 2), ("array", "bool", 1, 1),
    ("pil", "undecodable", "real", 0), ("bytes", None, "fully_synthetic", 1),
    ("path", "rgb255", "full_synthetic", 1), ("array", "gray", "Synthetic", 1),
    ("pil", "zeros", 2, 2), ("bytes", "float01", "spliced", 2),
    ("path", None, "REAL", 0), ("array", "bool", 2, 2)]


class SidSplit:
    """A split of the stand-in: its records by index, each read counted."""

    def __init__(self, rows):
        self.rows, self.reads = rows, []

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        self.reads.append(i)
        return self.rows[i]


def sid_records(n, seed, root):
    """n seeded SID_Set records cycling through SID_VARIANTS, and what the
    mapping must make of each: (records, [(cls, has_mask, mask sum at
    SID_SOURCE / 2)]). A mask is a rectangle on even rows and columns, so
    that its NEAREST halving keeps a quarter of its pixels exactly."""
    import io

    import numpy as np
    from PIL import Image
    rng = np.random.default_rng(seed)
    s = SID_SOURCE
    records, expect = [], []
    for i in range(n):
        img_kind, mask_kind, label, cls = SID_VARIANTS[i % len(SID_VARIANTS)]
        px = rng.integers(0, 256, (s, s, 3), np.uint8)
        if img_kind == "pil":
            image = Image.fromarray(px)
        elif img_kind == "bytes":
            buf = io.BytesIO()
            Image.fromarray(px).save(buf, "PNG")
            image = {"bytes": buf.getvalue(), "path": None}
        elif img_kind == "path":
            image = {"bytes": None, "path": os.path.join(root, f"{i}.png")}
            Image.fromarray(px).save(image["path"])
        else:
            image = px
        y0, x0, h, w = (2 * int(v) for v in rng.integers(8, s // 4, 4))
        m = np.zeros((s, s), np.uint8)
        m[y0:y0 + h, x0:x0 + w] = 255
        m[0, :] = 127                    # at the 0-255 threshold: 0
        area = (h // 2) * (w // 2)
        mask = {"rgb255": np.dstack([m, 255 - m, m]),
                "gray": Image.fromarray(m),
                "float01": (m > 127).astype(np.float32) * 0.75,
                "bool": m > 127,
                "zeros": np.zeros((s, s), np.uint8),
                "undecodable": {"bytes": None, "path": None},
                None: None}[mask_kind]
        rec = {"image": image, "label": label}
        if mask is not None:
            rec["mask"] = mask
        records.append(rec)
        decodes = mask_kind not in (None, "undecodable")
        expect.append((cls, decodes, area if decodes and mask_kind != "zeros"
                       else 0))
    return records, expect


def sid_stand_in(calls, splits=None, fail=None):
    """The stand-in `datasets` module: load_dataset records (name, split,
    streaming) and serves the split, or raises `fail`."""
    import types
    mod = types.ModuleType("datasets")

    def load_dataset(name, split=None, streaming=False):
        calls.append((name, split, streaming))
        if fail is not None:
            raise fail
        return splits[split]

    mod.load_dataset = load_dataset
    return mod


# The stand-in `datasets` package that phase 3s puts on PYTHONPATH for the
# CLI's own process: it serves the records pickled beside it and, at exit,
# writes what the CLI asked of it, each training step's launches and loss
# and the process's launches to log.json beside them.
SID_SHIM = '''"""A stand-in `datasets`: load_dataset serves pickled records."""
import atexit
import json
import os
import pickle

import tpudf_torch.entry as _entry
from tpudf_torch.core.backend import LAUNCHES

_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(_DIR, "records.pkl"), "rb") as _f:
    _SPLITS = pickle.load(_f)
_LOG = {"calls": [], "reads": {}, "steps": []}


class _Split:
    def __init__(self, split):
        self.split, self.rows = split, _SPLITS[split]

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        _LOG["reads"].setdefault(self.split, []).append(i)
        return self.rows[i]


def load_dataset(name, split=None, streaming=False):
    _LOG["calls"].append([name, split, streaming])
    return _Split(split)


def _counted(make):
    def wrapped(*a, **k):
        init_fn, step = make(*a, **k)

        def counted(*sa, **sk):
            before = LAUNCHES.snapshot()
            out = step(*sa, **sk)
            after = LAUNCHES.snapshot()
            _LOG["steps"].append([{n: v - before.get(n, 0)
                                   for n, v in after.items()
                                   if v != before.get(n, 0)},
                                  float(out[1]["loss"])])
            return out
        return init_fn, counted
    return wrapped


# the CLI builds its trainer after it has read its data: its step counted
_entry.make_mtl_train_step = _counted(_entry.make_mtl_train_step)


@atexit.register
def _dump():
    _LOG["run"] = LAUNCHES.snapshot()
    with open(os.path.join(_DIR, "log.json"), "w") as f:
        json.dump(_LOG, f)
'''


def sid_cli_process(argv, data, tmp):
    """`python -m tpudf_torch.cli.train_mtl argv` in a process of its own
    with SID_SHIM as its `datasets`, serving data's records. Returns
    (load_dataset calls, reads by split, [(launches, loss)] a step, the
    process's launches)."""
    import pickle
    shim = os.path.join(tmp, "sid_shim")
    os.makedirs(os.path.join(shim, "datasets"), exist_ok=True)
    with open(os.path.join(shim, "records.pkl"), "wb") as f:
        pickle.dump({k: v[0] for k, v in data.items()}, f)
    with open(os.path.join(shim, "datasets", "__init__.py"), "w") as f:
        f.write(SID_SHIM)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [shim] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    run = subprocess.run(
        [sys.executable, "-m", "tpudf_torch.cli.train_mtl"] + argv,
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        capture_output=True, text=True, timeout=600)
    if run.returncode != 0:
        raise AssertionError(f"s1 CLI failed: {run.stderr[-4000:]}")
    with open(os.path.join(shim, "log.json")) as f:
        log = json.load(f)
    return ([tuple(c) for c in log["calls"]], log["reads"],
            [(launched, loss) for launched, loss in log["steps"]], log["run"])


def sid_paths(dev, card, tmp, step_expect):
    """Phase 3s: the MTL CLI without --data_dir at SID_MODEL, 256 px, B =
    16, freeze_below MTL_FREEZE, one epoch, on SID_RECORDS records of every
    schema variant (`sid_records`) that a stand-in `datasets` serves: (a)
    float as `python -m tpudf_torch.cli.train_mtl` in a process of its own
    (`sid_cli_process`), (b) --int8_frozen by its `main` in this process.
    Held: the stand-in saw saberzl/SID_Set's train and validation splits
    and each record was read once; each step launches what phase 3 (d)'s
    step launches (`step_expect`, (a) float / (b) int8); the losses finite,
    the log and checkpoint written; the frozen leaves of the checkpoint
    bit-identical to the seed-0 tree's and every trainable slice moved; in
    (b), every record's arrays, as the CLI mapped them, carry the expected
    class, has_mask and mask sum. A stand-in that raises ends the CLI with
    "provide --data_dir"."""
    import numpy as np
    import torch
    import tpudf_torch.entry as entry
    from tpudf_torch.cli import train_mtl
    from tpudf_torch.core.backend import LAUNCHES
    from tpudf_torch.data import datasets
    from tpudf_torch.ops import attention
    from tpudf_torch.train.checkpoint import restore_checkpoint

    print(f"phase 3s: the MTL CLI on SID_Set records through a stand-in "
          f"`datasets` ({SID_MODEL})", flush=True)
    t0 = time.perf_counter()
    root = os.path.join(tmp, "sid_set")
    os.makedirs(root, exist_ok=True)
    data = {split: sid_records(n, 40 + j, root)
            for j, (split, n) in enumerate(SID_RECORDS.items())}
    # the CLI's seed-0 tree, built here on the host
    tree = entry.mtl_params("cpu", seed=0, cfg_name=SID_MODEL,
                            seg_layers=SID_TAPS)
    init = {"frozen": frozen_values(tree, MTL_FREEZE),
            "slices": trainable_slices(tree, "data", MTL_FREEZE)}
    del tree
    print(f"s0: {sum(SID_RECORDS.values())} seeded records of "
          f"{len(SID_VARIANTS)} schema variants at {SID_SOURCE} px and the "
          f"seed-0 tree in {time.perf_counter() - t0:.2f} s", flush=True)
    size = entry.CONFIGS[SID_MODEL].image_size
    argv = ["--model_size", SID_MODEL, "--image_size", str(size),
            "--freeze_below", str(MTL_FREEZE), "--epochs", "1",
            "--batch_size", str(MTL_BATCH), "--device", dev.type,
            "--seg_layers", *map(str, SID_TAPS)]
    n_steps = SID_RECORDS["train"] // MTL_BATCH
    want_calls = [("saberzl/SID_Set", s, False) for s in SID_RECORDS]
    want_reads = {k: list(range(n)) for k, n in SID_RECORDS.items()}

    def held(label, key, calls, reads, steps, run, save):
        """The checks both runs share; returns what they read."""
        reads = {k: sorted(v) for k, v in reads.items()}
        if calls != want_calls or reads != want_reads:
            raise AssertionError(f"{label}: load_dataset calls {calls}, "
                                 f"reads {reads}")
        for i, (launched, _) in enumerate(steps):
            check_launches(f"{label} step {i}", launched, step_expect[key])
        losses = [v for _, v in steps]
        rows = open(os.path.join(save, "training_log.csv")
                    ).read().splitlines()
        state = restore_checkpoint(os.path.join(save, "best"))
        frozen_ok = all(torch.equal(a, b) for a, b in zip(
            init["frozen"], frozen_values(state["params"], MTL_FREEZE)))
        final = trainable_slices(state["params"], "data", MTL_FREEZE)
        still = [n for n, v in init["slices"].items()
                 if torch.equal(v, final[n])]
        if (len(steps) != n_steps or not np.isfinite(losses).all()
                or len(rows) != 2 or state["step"] != n_steps
                or not frozen_ok or still
                or run.get(attention.KERNEL_BWD, 0)
                != n_steps * step_expect[key][attention.KERNEL_BWD]):
            raise AssertionError(
                f"{label}: steps {len(steps)}, losses {losses}, log {rows}, "
                f"checkpoint step {state['step']}, frozen bit-identical "
                f"{frozen_ok}, trainable slices that did not move "
                f"{still[:4]}, the run's launches {run}")
        return (f"load_dataset {calls}; {len(reads['train'])} + "
                f"{len(reads['validation'])} records read once each; "
                f"launches per step {steps[0][0]}; the run's {run}; losses "
                f"{['%.6f' % v for v in losses]}; log {rows[1][:120]}; "
                f"checkpoint step {state['step']}, {len(init['frozen'])} "
                f"frozen leaves bit-identical, {len(final)} trainable "
                f"slices moved")

    # (a) the float route as a user launches it
    save = os.path.join(tmp, "sid_run_a")
    t0 = time.perf_counter()
    out = sid_cli_process(argv + ["--save_dir", save], data, tmp)
    secs = time.perf_counter() - t0
    print(f"s1 (a): python -m tpudf_torch.cli.train_mtl without --data_dir "
          f"({SID_MODEL}, {size} px, B={MTL_BATCH}, freeze_below "
          f"{MTL_FREEZE}; a process of its own, its start included) in "
          f"{secs:.2f} s: {held('s1 (a)', 'a', *out, save)} [{card}]",
          flush=True)

    # (b) --int8_frozen by main in this process, each mapped record held
    saved = sys.modules.get("datasets")
    orig = (entry.build_mtl_trainer, datasets.sid_example_to_arrays)
    calls, mapped, steps = [], [], []
    splits = {k: SidSplit(v[0]) for k, v in data.items()}

    def mapping(ex, image_size):
        out = orig[1](ex, image_size)
        mapped.append(out)
        return out

    def trainer(*a, **k):
        state, step, eval_step = orig[0](*a, **k)

        def counted(*sa, **sk):
            # the step's launches: the counts' growth over it (the run's
            # counts stay whole)
            before = LAUNCHES.snapshot()
            out = step(*sa, **sk)
            after = LAUNCHES.snapshot()
            steps.append(({k: v - before.get(k, 0) for k, v in after.items()
                           if v != before.get(k, 0)},
                          float(out[1]["loss"])))
            return out
        return state, counted, eval_step

    try:
        sys.modules["datasets"] = sid_stand_in(calls, splits)
        entry.build_mtl_trainer = trainer
        datasets.sid_example_to_arrays = mapping
        save = os.path.join(tmp, "sid_run_b")
        t0 = time.perf_counter()
        LAUNCHES.reset()
        train_mtl.main(argv + ["--save_dir", save, "--int8_frozen"])
        torch.cuda.synchronize()
        run = LAUNCHES.snapshot()
        secs = time.perf_counter() - t0
        entry.build_mtl_trainer = orig[0]
        datasets.sid_example_to_arrays = orig[1]
        said = held("s2 (b)", "b", calls,
                    {k: s.reads for k, s in splits.items()}, steps, run,
                    save)
        expect = data["train"][1] + data["validation"][1]
        got = [(m["cls"], m["has_mask"], int(m["mask"].sum()))
               for m in mapped]
        shapes_ok = all(
            m["pixels"].shape == (size, size, 3)
            and m["pixels"].dtype == np.uint8
            and m["mask"].shape == (size, size)
            and m["binary"] == float(m["cls"] > 0) for m in mapped)
        bad = [(i, g, e) for i, (g, e) in enumerate(zip(got, expect))
               if g != e]
        if bad or len(got) != len(expect) or not shapes_ok:
            raise AssertionError(f"s2 (b): mapped records off their "
                                 f"expectation {bad[:4]} (of {len(got)}; "
                                 f"shapes {shapes_ok})")
        classes = np.bincount([g[0] for g in got], minlength=3).tolist()
        print(f"s2 (b): train_mtl.main without --data_dir ({SID_MODEL}, "
              f"{size} px, B={MTL_BATCH}, freeze_below {MTL_FREEZE}, "
              f"--int8_frozen; in this process) in {secs:.2f} s: {said}; "
              f"mapped classes {classes}, has_mask "
              f"{sum(g[1] for g in got)}, mask sums equal the expected "
              f"{sum(g[2] for g in got)} pixels [{card}]", flush=True)
        del mapped

        # a stand-in that raises: the CLI exits, pointing at --data_dir
        calls = []
        sys.modules["datasets"] = sid_stand_in(
            calls, fail=ConnectionError("no network"))
        t0 = time.perf_counter()
        try:
            train_mtl.main(argv + ["--save_dir", os.path.join(tmp, "sid_x")])
        except SystemExit as e:
            msg = str(e)
        else:
            msg = None
        if (msg != "SID_Set unavailable (no network); provide --data_dir"
                or calls != [("saberzl/SID_Set", "train", False)]):
            raise AssertionError(f"s3: the CLI without SID_Set: {msg!r}, "
                                 f"calls {calls}")
        print(f"s3: a stand-in that raises: SystemExit({msg!r}) after "
              f"{time.perf_counter() - t0:.2f} s (the tree first, as in "
              f"JAX) [{card}]", flush=True)
    finally:
        entry.build_mtl_trainer = orig[0]
        datasets.sid_example_to_arrays = orig[1]
        if saved is None:
            sys.modules.pop("datasets", None)
        else:
            sys.modules["datasets"] = saved
    torch.cuda.empty_cache()


_START = [time.perf_counter()] * 2     # the script's start, the last mark
_LAP = [time.perf_counter()]           # the last lap or clock line


def lap(label):
    """Print the wall time of a part of a phase (since the last lap or
    clock line) without closing the phase."""
    now = time.perf_counter()
    print(f"lap: {label} {now - _LAP[0]:.1f} s", flush=True)
    _LAP[0] = now


# The trainers (phase 3x, `trainer_paths`; phase 4, `trainer_timings`): the
# experts CLI, the video trainer's CLI (float and W8A8) and the face nets'
# pretraining, at base-256 on random weights from seed 0.
EXPERTS_PER_CLASS, EXPERTS_BATCH = 64, 64
VIDEO_CLIPS, VIDEO_VAL, VIDEO_T, VIDEO_B = 16, 4, 8, 8
FACE_STEPS = 10
TRAINER_MODEL = "base-256"      # a test config rehearses phase 3x on the CPU
# the corpus pass's 24-d standardised features against the twins' pass,
# max |Δ| (7.153e-7 read on an H100; the same pass on a gray plane rounded
# to bf16, the planted fault, must land above it). z_sig keeps phase 3r's
# engine rule, 5e-2.
FEATURE_TOL = 4e-6
# the face nets after FACE_STEPS Adam steps on the card against the same
# steps on the CPU: each step's loss and the nets' outputs on a probe batch
# by |Δ| / (1 + |x|), f32 both sides with TF32 off; a limit for each net
# between its sound reading and the same run with TF32 on (the planted
# fault, which must land above it). Read on an H100: the landmark net
# 9.5e-5 to 9.8e-5 sound (Adam's sign-sized steps on near-zero gradients
# carry f32 noise), 1.8e-2 with TF32; the identity net 1.0e-6 sound, 1.2e-2
# with TF32.
FACE_TRAIN_TOL = {"landmark": 3e-4, "identity": 5e-6}
# --analysis (x2): the keys JAX's battery writes for a 2-epoch history,
# the figure suite's files, and the activation statistics against the
# same head on the twins' features of the validation batch: (max over
# diversity and feature-learning score of |Δ| / |x|, |Δsparsity|); the
# planted fault of the CPU rehearsal, the statistics taken on the first
# training batch, read 3.8e-1 / 3.6e-2
ANALYSIS_KEYS = {"activation_diversity", "activation_sparsity",
                 "confidence", "confidence_gap", "feature_learning_score",
                 "generalization_gap", "generalization_ratio",
                 "learning_score", "learning_type", "memorization_score",
                 "overconfidence_ratio", "train_confidence",
                 "val_confidence"}
ANALYSIS_FIGURES = ("calibration_curve.png", "class_comparison.png",
                    "combined_curves.png", "confusion_matrix.png",
                    "confusion_matrix_normalized.png",
                    "metrics_comparison.png", "precision_recall_curve.png",
                    "probability_distribution.png", "roc_curve.png",
                    "threshold_analysis.png")
ANALYSIS_TOL = (2e-2, 2e-2)


def experts_folder(root, n, size, seed):
    """train/{REAL,FAKE} of n PNGs each: data/synth_detect's seeded real
    images and fakes with a generator artifact."""
    from PIL import Image
    from tpudf_torch.data.synth_detect import make_detect_batch
    imgs, labels = make_detect_batch(n, size, seed)
    for i, (img, y) in enumerate(zip(imgs, labels)):
        d = os.path.join(root, "train", "FAKE" if y else "REAL")
        os.makedirs(d, exist_ok=True)
        Image.fromarray(img).save(os.path.join(d, f"{i}.png"))


def video_folder(root, n_train, n_val, frames, size, seed):
    """train / val x REAL / FAKE of mp4v clips (`sampler_file`; the FAKE
    ones with a scene cut half way)."""
    for s, (split, n) in enumerate((("train", n_train), ("val", n_val))):
        for c, cls in enumerate(("REAL", "FAKE")):
            d = os.path.join(root, split, cls)
            os.makedirs(d, exist_ok=True)
            for i in range(n):
                sampler_file(os.path.join(d, f"{i}.mp4"), frames, size,
                             frames // 2 if c else None,
                             seed + 1000 * s + 100 * c + i)


def experts_path(dev, card, tmp):
    """(x1) `python -m tpudf_torch.cli.train_experts --v5` in process on
    a train/{REAL,FAKE} folder of 2 x 64 synthetic 256 px PNGs, the launch
    counts set to 0 just before it: per corpus batch of 64 one K3 and one
    bf16 tower forward, nothing else on the kernels; the corpus pass's
    features and z_sig against the same pass through the twins (phase 3r's
    engine rule: 5e-2, the z_freq / z_sig limit; the features by
    FEATURE_TOL, which the pass on a bf16-rounded gray plane must break);
    every artifact loads
    (the inference CLI's `build_engine --artifacts` at base-256, the v5
    expert's own loader) and a request of the engine built on them
    returns finite outputs, fused logits included."""
    import numpy as np
    import torch
    from tpudf_torch.cli import infer, train_experts
    from tpudf_torch.core.backend import LAUNCHES
    from tpudf_torch.models.freq_mlp import (apply_freq_mlp_v5,
                                             freq_mlp_v5_from_safetensors)
    from tpudf_torch.ops import srm
    from tpudf_torch.ops.fft_features import extract_freq_vector
    from tpudf_torch.ops.routes import TWINS
    data, save = os.path.join(tmp, "experts_data"), os.path.join(tmp,
                                                                 "experts")
    size = trainer_cfg().image_size
    experts_folder(data, EXPERTS_PER_CLASS, size, 41)
    calls = []
    orig = train_experts.corpus_pass

    def spy(*a, **k):
        out = orig(*a, **k)
        calls.append((a, k, out))
        return out

    argv = ["--data_dir", data, "--save_dir", save, "--model_size",
            TRAINER_MODEL, "--v5", "--freq_epochs", "10", "--fusion_steps",
            "100", "--batch_size", str(EXPERTS_BATCH), "--device", str(dev)]
    train_experts.corpus_pass = spy
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        LAUNCHES.reset()
        summary = train_experts.main(argv)
        torch.cuda.synchronize()
        launches = LAUNCHES.snapshot()
        wall = time.perf_counter() - t0
    finally:
        train_experts.corpus_pass = orig
    (args, kw, (feats, z_sig)), = calls
    n_img = 2 * EXPERTS_PER_CLASS
    batches = -(-n_img // EXPERTS_BATCH)
    per_batch = dict(tower_expect(trainer_cfg().layers, "A"),
                     **{srm.KERNEL: 1})
    check_launches("x1 experts CLI", launches,
                   {k: v * batches for k, v in per_batch.items()})
    feats_t, z_sig_t = orig(*args, **dict(kw, kernels=TWINS))
    d_f = float(np.abs(feats - feats_t).max())
    d_z = float(np.abs(z_sig - z_sig_t).max())
    print(f"x1 experts CLI ({TRAINER_MODEL}, {n_img} images, {batches} corpus "
          f"batches of {EXPERTS_BATCH}, --v5, 10 freq epochs, 100 fusion "
          f"steps): {wall:.2f} s; launches {launches} = {per_batch} a "
          f"corpus batch; vs twins max|Δ| features {d_f:.3e}, z_sig "
          f"{d_z:.3e}; summary {json.dumps(summary)} [{card}]", flush=True)
    if (feats.shape != (n_img, 24) or not np.isfinite(feats).all()
            or not np.isfinite(z_sig).all() or d_f > FEATURE_TOL
            or d_z > 5e-2):
        raise AssertionError(f"x1: corpus pass off its twins (features "
                             f"{d_f:.3e}, z_sig {d_z:.3e})")
    with torch.inference_mode():
        feats_bf16 = np.concatenate([
            extract_freq_vector(g.bfloat16().float(), TWINS).cpu().numpy()
            for _, g in train_experts._batches(
                args[0], size, EXPERTS_BATCH, dev)])
    d_bf16 = float(np.abs(feats - feats_bf16).max())
    print(f"  planted fault gray in bf16: features max|Δ| {d_bf16:.3e} "
          f"(limit {FEATURE_TOL:.0e})", flush=True)
    if d_bf16 <= FEATURE_TOL:
        raise AssertionError("x1: the features' limit misses the planted "
                             "fault gray in bf16")
    eng = infer.build_engine(infer.parse_args(
        ["--input", data, "--artifacts", save, "--model_size",
         TRAINER_MODEL, "--device", str(dev)]))
    with open(os.path.join(save, "coral_temp.json")) as f:
        temp = json.load(f)["temperature"]
    if eng.fusion is None or eng.cuts.temperature != temp:
        raise AssertionError("x1: the engine did not take the artifacts")
    px = report_images(8, size, 42)
    out = eng.fetch_batch(eng.dispatch_batch(px, True), True)
    bad = [k for k, v in out.items() if not np.isfinite(v).all()]
    v5 = apply_freq_mlp_v5(freq_mlp_v5_from_safetensors(
        os.path.join(save, "freq_mlp_v5.safetensors"), dev),
        torch.from_numpy(feats).to(dev))
    if bad or not torch.isfinite(v5).all():
        raise AssertionError(f"x1: not finite: {bad or 'the v5 expert'}")
    fw = eng.fusion["w"].flatten().tolist()
    print(f"x1 artifacts → DetectEngine (fusion w {fw}, CORAL T "
          f"{temp:.4f}): fast request B=8 z_scaled "
          f"{np.round(out['z_scaled'], 4).tolist()}; v5 expert on the "
          f"corpus finite [{card}]", flush=True)
    del eng
    return {"corpus": (orig, args, kw, n_img)}


def video_train_path(dev, card, tmp, data, int8):
    """(x2) `python -m tpudf_torch.cli.train_video` in process at the JAX
    defaults (base-256, --num_frames 8 --batch_size 8: 64 frames a step)
    for 2 epochs on `data` (16 clips a class; 4 a class in val), the
    launch counts set to 0 just before each train step and read after it:
    one tower forward and the head's LN (K4) a step, float or W8A8, and
    no K10; the first step's frame features against the twins' (pooled
    cosine >= 0.99), every loss finite, the ledger's 2 rows and a `best`
    checkpoint that restores and scores finite logits."""
    import numpy as np
    import torch
    from tpudf_torch.cli import train_video
    from tpudf_torch.core.backend import LAUNCHES
    from tpudf_torch.eval import analysis as an
    from tpudf_torch.models.heads import apply_video_head
    from tpudf_torch.ops import attention, layernorm
    from tpudf_torch.ops.routes import TWINS
    from tpudf_torch.train import video as tv
    from tpudf_torch.train.checkpoint import restore_checkpoint
    label = f"x2 video CLI {'W8A8' if int8 else 'bf16'}"
    save = os.path.join(tmp, "video_int8" if int8 else "video")
    rec = {"launches": [], "loss": [], "card": card}
    orig = tv.make_video_train_step

    def make(cfg, opt, policy, pos_w, *a, **k):
        init_fn, step = orig(cfg, opt, policy, pos_w, *a, **k)

        def counted(state, backbone, batch, generator=None):
            rec.setdefault("first", (backbone, batch, cfg, policy))
            torch.cuda.synchronize()
            LAUNCHES.reset()
            state, m = step(state, backbone, batch, generator)
            torch.cuda.synchronize()
            rec["launches"].append(LAUNCHES.snapshot())
            rec["loss"].append(float(m["loss"]))
            rec["step"], rec["state"] = step, state
            return state, m
        return init_fn, counted

    argv = ["--data_dir", data, "--save_dir", save, "--model_size",
            TRAINER_MODEL, "--num_frames", str(VIDEO_T), "--batch_size",
            str(VIDEO_B), "--epochs", "2", "--device", str(dev),
            "--analysis"]
    orig_analysis = train_video.publication_analysis
    orig_acts = an.video_head_activations

    def analysis(*a, **k):
        # the counts set to 0 just before the analysis, read just after
        torch.cuda.synchronize()
        LAUNCHES.reset()
        t0 = time.perf_counter()
        out = orig_analysis(*a, **k)
        torch.cuda.synchronize()
        rec["analysis"] = (LAUNCHES.snapshot(), time.perf_counter() - t0,
                           a[2], a[4], out)
        return out

    def acts(head, feats):
        rec["acts_in"] = feats
        return orig_acts(head, feats)

    tv.make_video_train_step = make
    train_video.publication_analysis = analysis
    an.video_head_activations = acts
    try:
        t0 = time.perf_counter()
        train_video.main(argv + (["--int8_backbone"] if int8 else []))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        tv.make_video_train_step = orig
        train_video.publication_analysis = orig_analysis
        an.video_head_activations = orig_acts
    steps = 2 * (2 * VIDEO_CLIPS // VIDEO_B)
    # one tower forward and the video head's LN over the bf16 features
    expect = tower_expect(trainer_cfg().layers, "B" if int8 else "A")
    expect[layernorm.KERNEL] += 1
    if len(rec["launches"]) != steps:
        raise AssertionError(f"{label}: {len(rec['launches'])} steps")
    for i, got in enumerate(rec["launches"]):
        if attention.KERNEL_BWD in got:
            raise AssertionError(f"{label} step {i}: K10 launched in the "
                                 f"frozen step: {got}")
        check_launches(f"{label} step {i}", got, expect)
    backbone, batch, cfg, policy = rec["first"]
    with torch.no_grad():
        kern = tv.video_frame_features(backbone, batch["frames"], cfg, policy)
        twin = tv.video_frame_features(backbone, batch["frames"], cfg, policy,
                                       kernels=TWINS)
    w = cfg.width
    msg = pooled_vs(f"{label} first step's frame features",
                    kern.reshape(-1, w), twin.reshape(-1, w))
    rows = open(os.path.join(save, "training_log.csv")).read().splitlines()
    best = restore_checkpoint(os.path.join(save, "best"), dev)
    z = apply_video_head(best["head"], kern.float())
    if (not np.isfinite(rec["loss"]).all() or len(rows) != 3
            or not torch.isfinite(z).all() or best["step"] < 1):
        raise AssertionError(f"{label}: losses {rec['loss']}, ledger "
                             f"{rows}, best logits {z}")
    print(f"{label} ({TRAINER_MODEL}, {2 * VIDEO_CLIPS} clips x {VIDEO_T} frames, "
          f"B={VIDEO_B}: {VIDEO_B * VIDEO_T} frames a step, 2 epochs): "
          f"{wall:.2f} s; launches per step {rec['launches'][0]} (no K10); "
          f"first step's features: {msg}; losses "
          f"{['%.4f' % v for v in rec['loss']]}; best (epoch "
          f"{best['epoch']}, step {best['step']}) logits "
          f"{np.round(z.cpu().numpy(), 4).tolist()}; ledger {rows[-1][:120]}"
          f" [{card}]", flush=True)
    analysis_checks(label, rec, expect, save, data, cfg, policy)
    return rec


def analysis_checks(label, rec, step_expect, save, data, cfg, policy):
    """(x2) --analysis after the video CLI's training: its launches exact
    (each eval batch of the sampled train / val confidences and the
    activation batch: one tower forward and the head's K4 each, as a step
    without its backward), learning_analysis.json's keys ANALYSIS_KEYS
    (JAX's for a 2-epoch history; tests/test_torch_port_video_train.py
    holds them to JAX on the CPU), the figures where matplotlib is
    installed, and the activation statistics against those of the same
    head on the twins' features of the same validation batch
    (ANALYSIS_TOL)."""
    import collections
    import json
    import torch
    from tpudf_torch.data.datasets import FolderVideoDataset
    from tpudf_torch.data.pipeline import normalize_siglip
    from tpudf_torch.eval.analysis import (activation_statistics,
                                           video_head_activations)
    from tpudf_torch.eval.plots import figures_available
    from tpudf_torch.ops.routes import TWINS
    from tpudf_torch.train import video as tv
    launches, secs, tower, head, (metrics, stats) = rec["analysis"]
    n_fwd = (min(-(-2 * VIDEO_CLIPS // VIDEO_B), 10)
             + min(-(-2 * VIDEO_VAL // VIDEO_B), 10) + 1)
    expect = collections.Counter()
    for _ in range(n_fwd):
        expect.update(step_expect)
    check_launches(f"{label} --analysis", launches, dict(expect))
    with open(os.path.join(save, "learning_analysis.json")) as f:
        keys = set(json.load(f))
    if keys != ANALYSIS_KEYS:
        raise AssertionError(f"{label}: learning_analysis.json keys "
                             f"{sorted(keys ^ ANALYSIS_KEYS)} differ")
    pngs = ["learning_vs_memorization.png"] + [
        os.path.join("figures", f) for f in ANALYSIS_FIGURES]
    if figures_available():
        missing = [f for f in pngs if not os.path.getsize(
            os.path.join(save, f))]
        if missing:
            raise AssertionError(f"{label}: empty figures {missing}")
        figs = f"{len(pngs)} figures written"
    else:
        figs = "no figures (matplotlib is not installed here)"
        print(f"{label} --analysis: matplotlib is not installed on this "
              f"machine: the figures are not checked", flush=True)
        if os.path.exists(os.path.join(save, "figures")):
            raise AssertionError(f"{label}: figures without matplotlib")
    val = FolderVideoDataset(data, "val", VIDEO_T, cfg.image_size)
    batch = next(iter(val.batches(VIDEO_B)))
    frames = normalize_siglip(torch.from_numpy(batch["frames"]).to(
        rec["acts_in"].device).float() / 255.0)
    with torch.no_grad():
        twin = tv.video_frame_features(tower, frames, cfg, policy,
                                       kernels=TWINS)
    ref = activation_statistics(video_head_activations(head, twin))
    apart = max(abs(stats[k] - ref[k]) / max(abs(ref[k]), 1e-3)
                for k in ("activation_diversity", "feature_learning_score"))
    d_sparse = abs(stats["activation_sparsity"]
                   - ref["activation_sparsity"])
    print(f"{label} --analysis ({TRAINER_MODEL}, {n_fwd} tower forwards): "
          f"{secs:.2f} s; launches {launches}; {metrics['learning_type']} "
          f"score {metrics['learning_score']:.2f}; {len(keys)} keys = "
          f"JAX's; {figs}; activation statistics vs the twins' features: "
          f"rel {apart:.3e} (limit {ANALYSIS_TOL[0]:.0e}), |Δsparsity| "
          f"{d_sparse:.3e} (limit {ANALYSIS_TOL[1]:.0e}) [{rec['card']}]",
          flush=True)
    if apart > ANALYSIS_TOL[0] or d_sparse > ANALYSIS_TOL[1]:
        raise AssertionError(f"{label}: activation statistics off the "
                             f"twins' ({apart:.3e}, {d_sparse:.3e})")
    rec["analysis_s"] = secs


def trainer_cfg():
    from tpudf_torch.models.siglip import CONFIGS
    return CONFIGS[TRAINER_MODEL]


def face_train_vs_cpu(dev, card):
    """(x3) FACE_STEPS steps of train_landmark_net (batch 16) and of
    train_face_embed (k_ids 8 of a 16-identity, 2-view pool) on the card
    and on the CPU, each from its seeded init, TF32 off (the trainers'
    f32_math): each step's loss and the trained nets' outputs on a probe
    batch by FACE_TRAIN_TOL; the card's run with TF32 on (the planted
    fault) must break it. Returns the card's trained trees."""
    import numpy as np
    import torch
    from tpudf_torch.models import face_embed, face_landmark
    from tpudf_torch.ops import forensics
    from tpudf_torch.train import steps
    probe = face_embed.render_crop_pool(np.random.default_rng(43), 4, 1)[:, 0]
    nets = {
        "landmark": (face_landmark.train_landmark_net,
                     dict(batch=16, size=64), face_landmark.landmark_forward),
        "identity": (face_embed.train_face_embed,
                     dict(k_ids=8, n_ids=16, pool_views=2),
                     face_embed.face_embed_forward)}
    orig = steps.fit_step
    losses = []

    def spy(*a, **k):
        st, loss = orig(*a, **k)
        losses.append(float(loss))
        return st, loss

    def run(train, kw, fwd, d):
        losses.clear()
        params = train(steps=FACE_STEPS, seed=0, device=d, **kw)
        out = fwd(params, torch.from_numpy(probe).to(d))
        out = out if isinstance(out, dict) else {"embedding": out}
        return list(losses), params, {k: v.cpu().double().numpy()
                                      for k, v in out.items()}

    def apart(got, want):
        (lg, _, og), (lw, _, ow) = got, want
        if len(lg) != FACE_STEPS or not np.isfinite(lg).all():
            return float("inf"), float("inf")
        return (max(abs(a - b) / (1 + abs(b)) for a, b in zip(lg, lw)),
                max(float((np.abs(og[k] - ow[k]) / (1 + np.abs(ow[k])))
                          .max()) for k in ow))

    trained = {}
    steps.fit_step = spy
    try:
        for name, (train, kw, fwd) in nets.items():
            card_run, cpu_run = (run(train, kw, fwd, d) for d in (dev, "cpu"))
            with tf32_on(forensics):
                fault_run = run(train, kw, fwd, dev)
            (d_loss, d_out), (f_loss, f_out) = (apart(card_run, cpu_run),
                                                apart(fault_run, cpu_run))
            tol = FACE_TRAIN_TOL[name]
            print(f"x3 face {name} net: {FACE_STEPS} steps on the card vs "
                  f"the CPU: losses {['%.5f' % v for v in card_run[0]]}; "
                  f"|Δ|/(1+|x|) loss {d_loss:.3e}, outputs on 4 probe crops "
                  f"{d_out:.3e} (limit {tol:.0e}); planted fault TF32 on: "
                  f"loss {f_loss:.3e}, outputs {f_out:.3e} [{card}]",
                  flush=True)
            if max(d_loss, d_out) > tol:
                raise AssertionError(f"x3 face {name} net off its CPU run "
                                     f"(loss {d_loss:.3e}, outputs "
                                     f"{d_out:.3e})")
            if max(f_loss, f_out) <= tol:
                raise AssertionError(f"x3 face {name} net: the limit misses "
                                     f"the planted fault TF32 on")
            trained[name] = card_run[1]
    finally:
        steps.fit_step = orig
    return trained


def trainer_paths(dev, card, tmp):
    """Phase 3x: the trainers on the card, at base-256 on random weights
    from seed 0: (x1) the experts CLI, (x2) the video CLI float and W8A8,
    (x3) the face nets against their CPU runs. Returns what phase 4
    times."""
    print("phase 3x: the trainers (experts CLI, video CLI, face nets)",
          flush=True)
    state = experts_path(dev, card, tmp)
    data = os.path.join(tmp, "video_data")
    video_folder(data, VIDEO_CLIPS, VIDEO_VAL, 2 * VIDEO_T,
                 trainer_cfg().image_size, 44)
    for int8 in (False, True):
        state[("video", int8)] = video_train_path(dev, card, tmp, data, int8)
    state["face"] = face_train_vs_cpu(dev, card)
    state["dev"] = dev
    return state


def trainer_timings(state, card):
    """Phase 4 of phase 3x's paths: the video trainer's step float and
    W8A8 (B = 8 clips x 8 frames) in ms by CUDA events after warm-up, with
    a profile (its idle share); the experts' corpus pass in img/s (PNG
    decode and gray plane on the host included); a face-net step of each
    net at its CLI's batch (host batch synthesis included)."""
    import numpy as np
    import torch
    from tpudf_torch.models import face_embed, face_landmark
    dev = state.pop("dev")
    for int8 in (False, True):
        rec = state.pop(("video", int8))
        backbone, batch = rec["first"][:2]
        box = {"state": rec["state"]}
        gen = torch.Generator(device=dev).manual_seed(7)

        def vstep():
            box["state"], _ = rec["step"](box["state"], backbone, batch, gen)

        label = (f"video train step {TRAINER_MODEL} "
                 f"{'W8A8' if int8 else 'bf16'}")
        print(f"video CLI {TRAINER_MODEL} {'W8A8' if int8 else 'bf16'} "
              f"--analysis: {rec['analysis_s']:.3f} s wall (host clock: "
              f"the sampled confidences, the activation batch, the metric "
              f"battery, the JSON and any figures) [{card}]", flush=True)
        ms = cuda_ms(vstep, iters=10, warmup=3)
        n = VIDEO_B * VIDEO_T
        print(f"{label} B={VIDEO_B}x{VIDEO_T}: {ms:.3f} ms = "
              f"{n * 1e3 / ms:.1f} frames/s [{card}]", flush=True)
        profile(vstep, f"{label} B={VIDEO_B}x{VIDEO_T}", card, top=6)
        del rec, box
    orig, args, kw, n_img = state.pop("corpus")
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        orig(*args, **kw)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
    print(f"experts corpus pass {TRAINER_MODEL} ({n_img} PNGs, batches of "
          f"{EXPERTS_BATCH}): {s:.3f} s = {n_img / s:.1f} img/s [{card}]",
          flush=True)
    trained = state.pop("face")
    pool = face_embed.render_crop_pool(np.random.default_rng(45), 64, 2)
    for name, run in (
            ("landmark (batch 64, 64 px)", lambda p: face_landmark
             .train_landmark_net(p, steps=5, batch=64, device=dev)),
            ("identity (k_ids 32, 2 views)", lambda p: face_embed
             .train_face_embed(p, steps=5, k_ids=32, pool=pool,
                               device=dev))):
        p = trained["landmark" if name.startswith("landmark") else
                    "identity"]
        run(p)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(p)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / 5
        print(f"face {name} train step: {ms:.3f} ms (host batch synthesis "
              f"included) [{card}]", flush=True)


# Phase 3p: data- and tensor-parallel scale-out over torch.distributed
# (`parallel_paths`; phase 4 times p1 in `parallel_timings`). p1 is a world
# of 1 on NCCL in this process; p2 (2 ranks) and p3 (4 ranks, mesh (2, 2))
# are gloo worlds whose ranks all sit on cuda:0 (NCCL refuses two ranks on
# one device), started by torchrun on this script (`--parallel-rank`),
# each rank only loading the library phase 1 built. Their CUDA tensors
# cross ranks through host memory (parallel/dist.py); their timings are
# correctness-only: the ranks share one card.
PAR_MODEL = "base-256"          # a test config rehearses phase 3p on the CPU
PAR_LAYERS = None               # None: the config's depth (the gpu tests cut it)
PAR_TRAIN_B, PAR_TRAIN_N, PAR_SEED = 8, 24, 7     # 3 steps of B = 8
PAR_DETECT_B = (8, 13)          # p1's request; p3's over a data axis of 2
# limits, each between the sound reading and a planted fault of the CPU
# rehearsal (CHANGES.md):
#  p1 runs the single process' arithmetic: |Δloss| a step and max |Δp| of
#     every trained leaf against the replay (the fault: the step's
#     generator not passed, no dropout or mixup);
#  p2 / p3's tower: the pooled cosine to the single-process forward and
#     max |Δ| / max |ref| (the fault: QKV split contiguously on the fused
#     3W axis);
#  p3's steps: |Δloss| / (1 + |loss|) a step and the cosine of the 3 steps'
#     update to the replay's, per group (the faults: the data all-reduce
#     skipped; the dropout drawn for the rank's rows alone);
#  p3's request: max |Δ| of every output over its 13 real rows (the fault:
#     the gathered rows in the wrong order).
P1_TOL = 1e-6
P2_COS, P2_REL = 0.999, 5e-2
P3_LOSS, P3_COS = 2e-2, 0.9
P3_DETECT = 1e-5


def par_cfg():
    import dataclasses
    from tpudf_torch.models.siglip import CONFIGS
    cfg = CONFIGS[PAR_MODEL]
    return cfg if PAR_LAYERS is None else dataclasses.replace(
        cfg, layers=PAR_LAYERS)


def par_trainer(cfg, dev):
    """(params, optimizer, step) of the binary trainer with the tower
    trained (v5 head, dropout, mixup 0.2), from seeds: each run and its
    replay build the same."""
    import torch
    from tpudf_torch.core.precision import tree_map
    from tpudf_torch.models.heads import init_binary_head
    from tpudf_torch.models.siglip import init_siglip
    from tpudf_torch.train.steps import make_binary_train_step, make_optimizer
    bb = init_siglip(torch.Generator().manual_seed(3), cfg)
    head = init_binary_head(torch.Generator().manual_seed(4), cfg.width)
    params = tree_map(lambda t: t.to(dev), {"backbone": bb, "head": head})
    opt = make_optimizer(lr=1e-3, warmup_steps=1, total_steps=8,
                         grad_clip=1.0)
    step = make_binary_train_step(cfg, opt, train_backbone=True,
                                  mixup_alpha=0.2)
    return params, opt, step


def par_data(cfg):
    """The trainer's PAR_TRAIN_N SigLIP-normalised images and labels, the
    TP forward's first PAR_TRAIN_B of them, the requests' uint8 images."""
    import numpy as np
    rng = np.random.default_rng(PAR_SEED)
    s = cfg.image_size
    pixels = (rng.random((PAR_TRAIN_N, s, s, 3), np.float32) * 2 - 1)
    labels = (np.arange(PAR_TRAIN_N) % 2).astype(np.float32)
    images = rng.integers(0, 256, (max(PAR_DETECT_B), s, s, 3), np.uint8)
    return pixels, labels, images


def par_steps(trainer_step, mesh, pixels, labels, dev):
    """The 3 global batches of HostShardedSampler(seed 1) through a
    ShardedTrainer's step (this rank's rows), each with its launches."""
    from tpudf_torch.core.backend import LAUNCHES
    from tpudf_torch.parallel.hostdata import HostShardedSampler
    from tpudf_torch.parallel.training import batch_generator
    sampler = HostShardedSampler(PAR_TRAIN_N, PAR_TRAIN_B, seed=1, mesh=mesh)
    losses, launches = [], []
    for bi, idx in enumerate(sampler.local_batches(0)):
        _sync(dev)
        LAUNCHES.reset()
        m = trainer_step({"pixels": pixels[idx], "labels": labels[idx]},
                         batch_generator(PAR_SEED, bi, dev))
        _sync(dev)
        launches.append(LAUNCHES.snapshot())
        losses.append(float(m["loss"]))
    return losses, launches


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def par_replay(cfg, dev, pixels, labels):
    """The single-process replay of the trainer's 3 global batches and
    generators: (losses, launches a step, final params, initial params)."""
    import torch
    from tpudf_torch.core.backend import LAUNCHES
    from tpudf_torch.core.precision import tree_map
    from tpudf_torch.parallel.hostdata import HostShardedSampler
    from tpudf_torch.parallel.training import batch_generator
    from tpudf_torch.train.steps import init_train_state
    params, opt, step = par_trainer(cfg, dev)
    init = tree_map(lambda t: t.detach().to("cpu", copy=True), params)
    state = init_train_state(params, opt)
    order = HostShardedSampler(PAR_TRAIN_N, PAR_TRAIN_B,
                               seed=1).epoch_order(0)
    losses, launches = [], []
    for bi in range(len(order) // PAR_TRAIN_B):
        idx = order[bi * PAR_TRAIN_B:(bi + 1) * PAR_TRAIN_B]
        batch = {"pixels": torch.from_numpy(pixels[idx]).to(dev),
                 "labels": torch.from_numpy(labels[idx]).to(dev)}
        _sync(dev)
        LAUNCHES.reset()
        state, m = step(state, None, batch,
                        batch_generator(PAR_SEED, bi, dev))
        _sync(dev)
        launches.append(LAUNCHES.snapshot())
        losses.append(float(m["loss"]))
    final = tree_map(lambda t: t.detach().to("cpu", copy=True),
                     state.params)
    return losses, launches, final, init


def par_train_expect(layers):
    """Launches of a train step of the tensor-parallel tower on one rank:
    K13 four times and K9 once a block, K10 once a block, K4 for the
    post-LN and the head's LN; no K14."""
    from tpudf_torch.ops import attention, layernorm, linear
    return {linear.KERNEL: 4 * layers, attention.KERNEL: layers,
            attention.KERNEL_BWD: layers, layernorm.KERNEL: 2}


def par_update_cos(final, init, ref_final):
    """Per group ("backbone", "head"): the cosine of the run's update
    (final - init) to the replay's, and max |Δp| between the two runs."""
    import torch
    from tpudf_torch.train.steps import tensor_leaves
    out = {}
    for g in ("backbone", "head"):
        def update(tree):
            return torch.cat([(f.detach().cpu().double() - i.double())
                              .flatten() for f, i in zip(
                                  tensor_leaves(tree[g]),
                                  tensor_leaves(init[g]), strict=True)])
        a, b = update(final), update(ref_final)
        out[g] = (float(torch.nn.functional.cosine_similarity(a, b, dim=0)),
                  float((a - b).abs().max()))
    return out


def p2_rank(dev, cfg):
    """p2's rank: the tower split by heads over a model axis of 2 at B =
    PAR_TRAIN_B: the pooled features, the launches of one forward, the
    forward's ms by the host clock (correctness-only)."""
    import torch
    from tpudf_torch.core.backend import LAUNCHES
    from tpudf_torch.core.mesh import make_mesh
    from tpudf_torch.models.siglip import init_siglip
    from tpudf_torch.parallel.inference import sharded_siglip_features
    mesh = make_mesh(1, 2, device=dev)
    bb = init_siglip(torch.Generator().manual_seed(PAR_SEED), cfg)
    run = sharded_siglip_features(mesh, bb, cfg, tensor_parallel=True)
    px = par_data(cfg)[0][:PAR_TRAIN_B]
    _sync(dev)
    LAUNCHES.reset()
    pooled = run(batch=px)
    _sync(dev)
    launches = LAUNCHES.snapshot()
    t0 = time.perf_counter()
    for _ in range(3):
        run(batch=px)
    _sync(dev)
    return {"pooled": pooled, "launches": launches,
            "ms": (time.perf_counter() - t0) * 1e3 / 3}


def p3_rank(dev, cfg):
    """p3's rank, mesh (2, 2): 3 ShardedTrainer steps with the tower
    trained and split by heads, then engine B's full analysis of
    PAR_DETECT_B[1] images over the data axis."""
    from tpudf_torch.core.backend import LAUNCHES
    from tpudf_torch.core.mesh import make_mesh
    from tpudf_torch.core.precision import tree_map
    from tpudf_torch.entry import build_engine
    from tpudf_torch.parallel.inference import sharded_detect_core
    from tpudf_torch.parallel.training import ShardedTrainer
    mesh = make_mesh(2, 2, device=dev)
    params, opt, step = par_trainer(cfg, dev)
    trainer = ShardedTrainer(mesh, step, opt, params, cfg=cfg)
    pixels, labels, images = par_data(cfg)
    t0 = time.perf_counter()
    losses, launches = par_steps(trainer.step, mesh, pixels, labels, dev)
    train_s = time.perf_counter() - t0
    final = tree_map(lambda t: t.detach().to("cpu", copy=True), {
        "backbone": trainer.backbone_params(cfg),
        "head": trainer.state.params["head"]})
    del trainer, params
    eng = build_engine(dev, seed=0, cfg_name=PAR_MODEL, int8=True,
                       tome=True, patch_tome=True)
    run = sharded_detect_core(mesh, eng)
    px = images[:PAR_DETECT_B[1]]
    _sync(dev)
    LAUNCHES.reset()
    got = run(px)
    _sync(dev)
    return {"losses": losses, "launches": launches, "final": final,
            "train_s": train_s, "detect": got,
            "detect_launches": LAUNCHES.snapshot(),
            "mesh": (mesh.data_index, mesh.model_index)}


def parallel_rank_main(argv) -> int:
    """A rank of p2 or p3, under torchrun: gloo on the given device, the
    kernel library that parallel_paths built loaded; its results to OUT/<phase>_rank<r>.pt."""
    import argparse
    import torch
    global PAR_MODEL, PAR_LAYERS
    p = argparse.ArgumentParser()
    p.add_argument("--parallel-rank", required=True, choices=("p2", "p3"))
    p.add_argument("--out", required=True)
    p.add_argument("--model", required=True)
    p.add_argument("--layers", type=int, default=0)
    p.add_argument("--device", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tpudf_torch.ops import _build
    from tpudf_torch.parallel.dist import initialize_from_env, shutdown, world
    PAR_MODEL, PAR_LAYERS = args.model, args.layers or None
    dev = torch.device(args.device)
    initialize_from_env(device=dev, backend="gloo")
    if dev.type == "cuda":
        _build.load()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    rank, _ = world()
    fn = p2_rank if args.parallel_rank == "p2" else p3_rank
    res = fn(dev, par_cfg())
    torch.save(res, os.path.join(args.out, f"{args.parallel_rank}_rank"
                                 f"{rank}.pt"))
    shutdown()
    return 0


def par_spawn(phase, nproc, out, dev):
    """torchrun of `nproc` ranks of this script's `--parallel-rank phase`
    (their output to OUT/<phase>.log)."""
    from tpudf_torch.parallel.dist import torchrun
    log = open(os.path.join(out, f"{phase}.log"), "w")
    args = [os.path.abspath(__file__), "--parallel-rank", phase, "--out", out,
            "--model", PAR_MODEL, "--layers", str(PAR_LAYERS or 0),
            "--device", str(dev)]
    return torchrun(nproc, args, stdout=log, stderr=subprocess.STDOUT), log


def par_wait(phase, proc, log, out, n, timeout=600):
    """Wait for a world; a rank that failed fails the phase. Returns the
    ranks' results."""
    import torch
    rc = proc.wait(timeout=timeout)
    log.close()
    if rc != 0:
        tail = open(os.path.join(out, f"{phase}.log")).read()[-6000:]
        raise AssertionError(f"{phase}: torchrun exited {rc}:\n{tail}")
    return [torch.load(os.path.join(out, f"{phase}_rank{r}.pt"),
                       weights_only=False) for r in range(n)]


def parallel_paths(dev, card, tmp, eng_b=None):
    """Phase 3p. (p1) a world of 1 on NCCL (gloo on the CPU) in this
    process: engine B's full request of PAR_DETECT_B[0] through
    sharded_detect_core, bit-equal to engine.predict_batch with its
    launches; 3 ShardedTrainer steps against the replay (P1_TOL).
    (p2) 2 gloo ranks: the tower split by heads against the
    single-process forward, exact launches. (p3) 4 gloo ranks, mesh (2,
    2): 3 trainer steps split by heads against the replay, exact launches
    a step; engine B's request of PAR_DETECT_B[1] over the data axis
    against the single-process request. Returns what phase 4 times."""
    import numpy as np
    import torch
    from tpudf_torch.core.backend import LAUNCHES
    from tpudf_torch.core.mesh import make_mesh
    from tpudf_torch.core.precision import DEFAULT_POLICY, tree_map
    from tpudf_torch.entry import build_engine
    from tpudf_torch.models.siglip import (init_siglip, siglip_forward,
                                           tower_params)
    from tpudf_torch.ops import attention, layernorm, linear, mlp
    from tpudf_torch.parallel import dist as pdist
    from tpudf_torch.parallel.inference import sharded_detect_core
    from tpudf_torch.parallel.training import ShardedTrainer
    print(f"phase 3p: data- and tensor-parallel paths ({PAR_MODEL}, "
          f"{par_cfg().layers} layers)", flush=True)
    cfg = par_cfg()
    out = os.path.join(tmp, "parallel")
    os.makedirs(out, exist_ok=True)
    if dev.type == "cuda":
        from tpudf_torch.ops import _build
        _build.load()      # built before the ranks start: each only loads it
    worlds = {ph: par_spawn(ph, n, out, dev) for ph, n in (("p2", 2),
                                                           ("p3", 4))}
    pixels, labels, images = par_data(cfg)
    if eng_b is None:
        eng_b = build_engine(dev, seed=0, cfg_name=PAR_MODEL, int8=True,
                             tome=True, patch_tome=True)
    n_tok = eng_b.cfg.num_patches
    b_expect = engine_expect(eng_b.cfg.layers, n_tok)[("B", "full")]

    # ---- p1: a world of 1 in this process
    backend = "nccl" if dev.type == "cuda" else "gloo"
    pdist.initialize(backend, device=dev, world_size=1, rank=0,
                     init_method=f"tcp://localhost:{pdist.free_port()}")
    mesh = make_mesh(1, 1, device=dev)
    run = sharded_detect_core(mesh, eng_b)
    px = images[:PAR_DETECT_B[0]]
    _sync(dev)
    LAUNCHES.reset()
    got = run(px)
    _sync(dev)
    launches = LAUNCHES.snapshot()
    check_launches("p1 sharded_detect_core", launches, b_expect)
    want = eng_b.predict_batch(px)
    if set(got) != set(want) or not all(np.array_equal(got[k], want[k])
                                        for k in want):
        bad = {k: float(np.abs(got[k] - want[k]).max()) for k in want
               if not np.array_equal(got[k], want[k])}
        raise AssertionError(f"p1: sharded_detect_core not bit-equal to "
                             f"predict_batch: {bad}")
    print(f"p1 world of 1 ({backend}): sharded_detect_core engine B "
          f"{PAR_MODEL} B={len(px)} bit-equal to predict_batch ("
          f"{len(want)} outputs), launches {launches} = the engine's "
          f"[{card}]", flush=True)
    ref_losses, ref_launches, ref_final, init = par_replay(cfg, dev, pixels,
                                                           labels)
    params, opt, step = par_trainer(cfg, dev)
    trainer = ShardedTrainer(mesh, step, opt, params, cfg=cfg)
    losses, p1_launches = par_steps(trainer.step, mesh, pixels, labels, dev)
    final = {"backbone": trainer.state.params["backbone"],
             "head": trainer.state.params["head"]}
    cos = par_update_cos(final, init, ref_final)
    d_loss = max(abs(a - b) for a, b in zip(losses, ref_losses))
    d_p = max(v[1] for v in cos.values())
    print(f"p1 ShardedTrainer {PAR_MODEL} tower trained B={PAR_TRAIN_B}, "
          f"{len(losses)} steps vs the replay: losses "
          f"{['%.6f' % v for v in losses]}, max |Δloss| {d_loss:.3e}, max "
          f"|Δp| {d_p:.3e} (limit {P1_TOL:.0e}); launches a step "
          f"{p1_launches[0]} [{card}]", flush=True)
    if d_loss > P1_TOL or d_p > P1_TOL:
        raise AssertionError(f"p1 trainer off its replay: |Δloss| "
                             f"{d_loss:.3e}, |Δp| {d_p:.3e}")
    for i, (a, b) in enumerate(zip(p1_launches, ref_launches)):
        check_launches(f"p1 train step {i}", a, b)
    del trainer, params, final
    state = {"run": run, "px": px, "eng": eng_b, "dev": dev}

    # ---- p2: 2 gloo ranks, the tower split by heads
    ranks = par_wait("p2", *worlds["p2"], out, 2)
    bb = tree_map(lambda t: t.to(dev), init_siglip(
        torch.Generator().manual_seed(PAR_SEED), cfg))
    with torch.no_grad():
        ref = siglip_forward(tower_params(bb, DEFAULT_POLICY.compute_dtype),
                             torch.from_numpy(pixels[:PAR_TRAIN_B]).to(dev),
                             cfg)["pooled"].float().cpu()
    del bb
    p2_expect = {linear.KERNEL: 4 * cfg.layers, attention.KERNEL: cfg.layers,
                 layernorm.KERNEL: 2}
    for r, res in enumerate(ranks):
        got = torch.from_numpy(res["pooled"])
        c = float(torch.nn.functional.cosine_similarity(got, ref).min())
        rel = float((got - ref).abs().max() / ref.abs().max())
        print(f"p2 rank {r}/2 (gloo, {dev} shared): TP tower {PAR_MODEL} "
              f"{cfg.layers} layers, {cfg.heads // 2} heads a rank, "
              f"B={PAR_TRAIN_B}: pooled cosine min {c:.6f} (limit "
              f"{P2_COS}), max|Δ|/max|ref| {rel:.3e} (limit {P2_REL:.0e}); "
              f"launches {res['launches']}; forward {res['ms']:.1f} ms "
              f"(correctness-only: two ranks share one card) [{card}]",
              flush=True)
        if c < P2_COS or rel > P2_REL:
            raise AssertionError(f"p2 rank {r}: TP forward off the single "
                                 f"process (cosine {c:.6f}, rel {rel:.3e})")
        check_launches(f"p2 rank {r}", res["launches"], p2_expect)
        if mlp.KERNEL_BF16 in res["launches"]:
            raise AssertionError("p2: K14 launched in the split block")

    # ---- p3: 4 gloo ranks, mesh (2, 2)
    ranks = par_wait("p3", *worlds["p3"], out, 4)
    step_expect = par_train_expect(cfg.layers)
    want = eng_b.predict_batch(images[:PAR_DETECT_B[1]])
    for r, res in enumerate(ranks):
        d_loss = max(abs(a - b) / (1 + abs(b)) for a, b in zip(
            res["losses"], ref_losses))
        cos = par_update_cos(res["final"], init, ref_final)
        worst = min(v[0] for v in cos.values())
        d_det = max(float(np.abs(res["detect"][k] - want[k]).max())
                    for k in want)
        print(f"p3 rank {r}/4 mesh (2, 2) at {res['mesh']} (gloo, {dev} "
              f"shared): {len(res['losses'])} TP steps, losses "
              f"{['%.5f' % v for v in res['losses']]} vs replay "
              f"{['%.5f' % v for v in ref_losses]}: |Δloss|/(1+|loss|) "
              f"{d_loss:.3e} (limit {P3_LOSS:.0e}); update cosine / max "
              f"|Δp| backbone {cos['backbone'][0]:.5f} / "
              f"{cos['backbone'][1]:.3e}, head {cos['head'][0]:.5f} / "
              f"{cos['head'][1]:.3e} (limit {P3_COS}); launches a step "
              f"{res['launches'][0]}; {res['train_s']:.2f} s for the steps "
              f"(correctness-only); engine B request of "
              f"{PAR_DETECT_B[1]} over the data axis: max |Δ| {d_det:.3e} "
              f"(limit {P3_DETECT:.0e}), launches {res['detect_launches']} "
              f"[{card}]", flush=True)
        if d_loss > P3_LOSS or worst < P3_COS:
            raise AssertionError(f"p3 rank {r}: trainer off its replay "
                                 f"(|Δloss| {d_loss:.3e}, cos {worst:.5f})")
        if d_det > P3_DETECT or set(res["detect"]) != set(want):
            raise AssertionError(f"p3 rank {r}: request off the single "
                                 f"process ({d_det:.3e})")
        for i, got in enumerate(res["launches"]):
            check_launches(f"p3 rank {r} step {i}", got, step_expect)
        check_launches(f"p3 rank {r} request", res["detect_launches"],
                       b_expect)
    return state


def parallel_timings(state, card):
    """Phase 4 of p1: the world-1 DP full analysis against the engine's
    own request (the wrapper's cost), by CUDA events; then p1's process
    group is shut down."""
    from tpudf_torch.parallel import dist as pdist
    eng, run, px = state["eng"], state["run"], state["px"]
    try:
        dp_ms, own_ms = paired_ms(lambda: run(px),
                                  lambda: eng.predict_batch(px), iters=5)
    finally:
        pdist.shutdown()
    print(f"DP full analysis (sharded_detect_core, world of 1, NCCL) engine "
          f"B {PAR_MODEL} B={len(px)}: {dp_ms:.3f} ms against the engine's "
          f"own request {own_ms:.3f} ms: the wrapper costs "
          f"{dp_ms - own_ms:+.3f} ms [{card}]", flush=True)


def clock(label):
    """Print the wall time of the section that ends here, and the time
    since the script started."""
    now = time.perf_counter()
    print(f"clock: {label} {now - _START[1]:.1f} s (at {now - _START[0]:.1f} "
          f"s)", flush=True)
    _START[1] = now
    _LAP[0] = now


def main() -> int:
    import numpy as np
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tpudf_torch.convert import add_kernel_layout
    from tpudf_torch.core.backend import LAUNCHES, has_triton
    from tpudf_torch.entry import (build, build_engine, build_mtl_trainer,
                                   detect_core, mtl_params)
    from tpudf_torch.models.siglip import siglip_forward
    from tpudf_torch.ops import (_build, attention, int8_block, layernorm,
                                 linear, mlp, quant, srm)
    from tpudf_torch.ops.quant import quantize_weight
    from tpudf_torch.ops.routes import KERNELS, TWINS
    from tpudf_torch.ops.tome import (DEPLOYED_PATCH_TOME_R, DEPLOYED_TOME_R,
                                      deployed_floor, deployed_patch_floor,
                                      merge_schedule)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = card_line()
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}"
          f" | triton {'present' if has_triton() else 'absent'} (unused: "
          f"every kernel is CUDA C++)", flush=True)

    # ---- 1. build
    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc "
          f"{_build.build_seconds} s) -> {_build.build_log} [{card}]",
          flush=True)
    for line in _build.build_log.read_text().splitlines():
        if "Compiling" in line or "Used" in line or "spill" in line:
            print("  ptxas:", line.strip())
    sass = sm90_sass_dump()
    sm90_build_checks(card)

    clock("build")

    # ---- 2. kernels vs twins
    rec = Records(card)
    g = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=g, device=dev) * std

    w, heads, hd, inter = 768, 12, 64, 3072
    ln1 = {"scale": 1.0 + randn(w, std=0.1), "bias": randn(w, std=0.1)}
    qkv_wq = add_kernel_layout(quantize_weight(randn(w, 3 * w, std=w ** -0.5)))
    out_wq = add_kernel_layout(quantize_weight(randn(w, w, std=w ** -0.5)))
    qkv_b, out_b = randn(3 * w, std=0.1), randn(w, std=0.1)
    a_qkv = torch.tensor(4.0, device=dev)
    a_out = torch.tensor(2.0, device=dev)
    mlp_q = add_kernel_layout({
        "fc1_w": quantize_weight(randn(w, inter, std=w ** -0.5)),
        "fc1_b": randn(inter, std=0.1),
        "fc2_w": quantize_weight(randn(inter, w, std=inter ** -0.5)),
        "fc2_b": randn(w, std=0.1)})
    mlp_sc = {"fc1": torch.tensor(4.0, device=dev),
              "fc2": torch.tensor(3.0, device=dev)}
    print("phase 2: kernels vs twins", flush=True)

    # K1: (8, 256, 768) without bias, (256, 32, 768) with bias log(size)
    for b, s, with_bias in ((8, 256, False), (256, 32, True)):
        x = randn(b, s, w).to(torch.bfloat16)
        lb = (torch.log(torch.randint(1, 9, (b, s), generator=g, device=dev)
                        .float()) if with_bias else None)
        args = (x, ln1, qkv_wq, qkv_b, out_wq, out_b, a_qkv, a_out, heads, hd)
        got = int8_block.attn_sublayer_int8(*args, logit_bias=lb)
        ref = int8_block.attn_sublayer_reference(*args, logit_bias=lb)
        torch.cuda.synchronize()
        # bf16 output: within a few bf16 steps; the twin rounds the
        # attention output to bf16 before its int8 quant (JAX reference
        # form), the kernel quantises the f32 output (TPU kernel)
        check_close(f"K1 {(b, s, w)} bias={with_bias}", got, ref,
                    atol=5e-2, rtol=2e-2)
        m = b * s
        a8 = torch.randint(-127, 128, (m, w), generator=g, device=dev,
                           dtype=torch.int8)
        q, k, v = (randn(b, heads, s, hd).to(torch.bfloat16)
                   for _ in range(3))
        mask = None if lb is None else lb[:, None, None, :].to(torch.bfloat16)
        rec.add("K1", "attn_sublayer_int8", (b, s, w), max_abs(got, ref),
                lambda: int8_block.attn_sublayer_int8(*args, logit_bias=lb),
                lambda: int8_block.attn_sublayer_reference(*args,
                                                           logit_bias=lb),
                ({"int8": 2 * m * w * 4 * w,
                  "bf16": 4 * b * heads * s * s * hd},
                 nbytes(x, ln1["scale"], ln1["bias"], qkv_wq["q"],
                        qkv_wq["scale"], qkv_b, out_wq["q"], out_wq["scale"],
                        out_b, a_qkv, a_out, lb) + nbytes(got)),
                library={
                    "part QKV _int_mm": lambda: torch._int_mm(
                        a8, qkv_wq["qT"].t()),
                    "part attention SDPA":
                        lambda: F.scaled_dot_product_attention(
                            q, k, v, attn_mask=mask),
                    "part out-proj _int_mm": lambda: torch._int_mm(
                        a8, out_wq["qT"].t())})

    # K2: (8*256, 768) rows, with and without Σout²
    x = randn(8, 256, w).to(torch.bfloat16)
    a8 = torch.randint(-127, 128, (8 * 256, w), generator=g, device=dev,
                       dtype=torch.int8)
    h8 = torch.randint(-127, 128, (8 * 256, inter), generator=g, device=dev,
                       dtype=torch.int8)
    for ss in (False, True):
        got = mlp.mlp_block_fused_int8(x, ln1, mlp_q, mlp_sc, emit_sumsq=ss)
        ref = mlp.mlp_block_int8_reference(x, ln1, mlp_q, mlp_sc,
                                           emit_sumsq=ss)
        torch.cuda.synchronize()
        if ss:
            (got, got_ss), (ref, ref_ss) = got, ref
            own = torch.sum(got.float() ** 2, dim=-1)
            check_close("K2 sumsq vs own output", got_ss, own, 0.0, 1e-4)
            check_close("K2 sumsq vs twin", got_ss, ref_ss, 0.0, 1e-3)
        check_close(f"K2 (2048, 768) sumsq={ss}", got, ref, atol=5e-2,
                    rtol=2e-2)
        rec.add("K2", "mlp_block_fused_int8", (2048, w, "sumsq" if ss else ""),
                max_abs(got, ref),
                lambda: mlp.mlp_block_fused_int8(x, ln1, mlp_q, mlp_sc,
                                                 emit_sumsq=ss),
                lambda: mlp.mlp_block_int8_reference(x, ln1, mlp_q, mlp_sc,
                                                     emit_sumsq=ss),
                ({"int8": 4 * 2048 * w * inter},
                 nbytes(x, ln1["scale"], ln1["bias"], mlp_q["fc1_w"]["q"],
                        mlp_q["fc1_w"]["scale"], mlp_q["fc1_b"],
                        mlp_q["fc2_w"]["q"], mlp_q["fc2_w"]["scale"],
                        mlp_q["fc2_b"], mlp_sc["fc1"], mlp_sc["fc2"])
                 + nbytes(got) + (2048 * 4 if ss else 0)),
                library={
                    "part fc1 _int_mm": lambda: torch._int_mm(
                        a8, mlp_q["fc1_w"]["qT"].t()),
                    "part fc2 _int_mm": lambda: torch._int_mm(
                        h8, mlp_q["fc2_w"]["qT"].t())})

    # K1 and K2 at every token count the deployed ToMe schedules give them
    # in engine B's full analysis of 8 images (checked, not timed): the 168
    # main views at r=96 / floor 32 and the 256 patch views at r=128 /
    # floor 16, with a key bias log(size); both K2 forms at each
    for views, r, floor in ((8 * 21, DEPLOYED_TOME_R, deployed_floor(256)),
                            (8 * 32, DEPLOYED_PATCH_TOME_R,
                             deployed_patch_floor(256))):
        s, errs = 256, []
        for ri in (0, *merge_schedule(256, 12, r, floor)):
            s -= ri
            if ri == 0 and s != 256:
                continue
            x = randn(views, s, w).to(torch.bfloat16)
            lb = torch.log(torch.randint(1, 9, (views, s), generator=g,
                                         device=dev).float())
            args = (x, ln1, qkv_wq, qkv_b, out_wq, out_b, a_qkv, a_out,
                    heads, hd)
            got = int8_block.attn_sublayer_int8(*args, logit_bias=lb)
            ref = int8_block.attn_sublayer_reference(*args, logit_bias=lb)
            check_close(f"K1 {(views, s, w)} bias", got, ref, atol=5e-2,
                        rtol=2e-2)
            errs.append(f"K1 S={s} {max_abs(got, ref):.3e}")
            for ss in (False, True):
                got = mlp.mlp_block_fused_int8(x, ln1, mlp_q, mlp_sc,
                                               emit_sumsq=ss)
                ref = mlp.mlp_block_int8_reference(x, ln1, mlp_q, mlp_sc,
                                                   emit_sumsq=ss)
                if ss:
                    # Σout² against the kernel's own output: against the
                    # twin's, one int8 rounding tie of the hidden can move a
                    # row's Σ by more than 1e-3 (seen in 1 row of 8192)
                    (got, got_ss), (ref, ref_ss) = got, ref
                    own = torch.sum(got.float() ** 2, dim=-1)
                    check_close(f"K2 {(views * s, w)} sumsq vs own output",
                                got_ss, own, 0.0, 1e-4)
                check_close(f"K2 {(views * s, w)} sumsq={ss}", got, ref,
                            atol=5e-2, rtol=2e-2)
            errs.append(f"K2 {max_abs(got, ref):.3e}")
        torch.cuda.synchronize()
        print(f"  ToMe shapes, {views} views r={r} floor={floor}: max|Δ| "
              f"{'; '.join(errs)} [{card}]", flush=True)
    del x, lb, got, ref

    # K3: (8, 256, 256) f32 grey images; f64 sums in the kernel vs f32
    # means in the twin
    gray = torch.rand((8, 256, 256), generator=g, device=dev)
    got = srm.srm_raw_moments(gray)
    ref = srm.srm_raw_moments_reference(gray)
    torch.cuda.synchronize()
    check_close("K3 (8, 256, 256)", got, ref, atol=1e-6, rtol=1e-4)
    # the library's parts: both stencils as one F.conv2d (f32, TF32 off),
    # then the four moments of both residuals
    stencils = torch.from_numpy(np.stack(
        [srm._norm(srm._K2), srm._norm(srm._K3)]))[:, None].to(dev)
    res = F.conv2d(gray[:, None], stencils, padding=1)
    powers = torch.arange(1, 5, device=dev, dtype=torch.float32)
    k3_work = ({"f32": K3_OPS_PER_PIXEL * gray.numel()},
               nbytes(gray) + nbytes(got))
    rec.add("K3", "srm_raw_moments", (8, 256, 256), max_abs(got, ref),
            lambda: srm.srm_raw_moments(gray),
            lambda: srm.srm_raw_moments_reference(gray), k3_work,
            library={
                "part F.conv2d (both stencils)": lambda: F.conv2d(
                    gray[:, None], stencils, padding=1),
                "part moments": lambda: torch.mean(res[..., None] ** powers,
                                                   dim=(2, 3))},
            device_time=True)
    # its bound: no kernel beats it (the device time at or above)
    k3_case = rec.rows["K3"]["cases"][-1]
    print(f"  K3 bound check: device {k3_case['device_ms']:.4f} ms = "
          f"{k3_case['device_ms'] / k3_case['bound_ms']:.1f}x its bound "
          f"{k3_case['bound_ms']:.4f} ms ({k3_case['bound_by']}) [{card}]",
          flush=True)
    if k3_case["device_ms"] < k3_case["bound_ms"]:
        raise AssertionError("K3: device time below its bound")
    del res

    # K4: (256*32, 768) bf16 rows; one bf16 rounding step
    x = (randn(256 * 32, w) * 3.0 + 0.5).to(torch.bfloat16)
    got = layernorm.layer_norm_fused(x, ln1["scale"], ln1["bias"])
    ref = layernorm.layer_norm_reference(x, ln1["scale"], ln1["bias"])
    torch.cuda.synchronize()
    check_close("K4 (8192, 768)", got, ref, atol=1e-6, rtol=2 ** -7)
    g16, b16 = ln1["scale"].to(torch.bfloat16), ln1["bias"].to(torch.bfloat16)
    rec.add("K4", "layer_norm_fused", (8192, w), max_abs(got, ref),
            lambda: layernorm.layer_norm_fused(x, ln1["scale"], ln1["bias"]),
            lambda: layernorm.layer_norm_reference(x, ln1["scale"],
                                                   ln1["bias"]),
            ({"f32": K4_OPS_PER_ELEMENT * x.numel()},
             nbytes(x, ln1["scale"], ln1["bias"]) + nbytes(got)),
            library={"F.layer_norm": lambda: F.layer_norm(x, (w,), g16, b16,
                                                          1e-6)},
            device_time=True)

    # the float engine's full analysis of 8 images: 424 views of 256
    # tokens, M = 108,544 rows, through K9, K13 and K14 per layer
    nv = 8 * VIEWS
    m = nv * 256
    bf = torch.bfloat16
    x = (randn(m, w)).to(bf)
    fw = {"qkv_w": randn(w, 3 * w, std=w ** -0.5).to(bf),
          "out_w": randn(w, w, std=w ** -0.5).to(bf),
          "fc1_w": randn(w, inter, std=w ** -0.5).to(bf),
          "fc2_w": randn(inter, w, std=inter ** -0.5).to(bf)}
    ln_pair = (ln1["scale"], ln1["bias"])

    # K9: qkv (424, 256, 2304) → (424, 256, 768); p is rounded to bf16 in
    # both, the sums run in another order: within two bf16 steps
    qkv = linear.linear_fused(x, fw["qkv_w"], qkv_b, ln=ln_pair).reshape(
        nv, 256, 3 * w)
    got = attention.attention_qkv(qkv, heads, hd)
    ref = attention.attention_qkv_reference(qkv, heads, hd)
    torch.cuda.synchronize()
    check_close("K9 (424, 256, 2304)", got, ref, atol=1e-2, rtol=2 ** -7)
    qv, kv_, vv = (qkv[..., i * w:(i + 1) * w].reshape(nv, 256, heads, hd)
                   .transpose(1, 2) for i in range(3))
    rec.add("K9", "attention_qkv", (nv, 256, 3 * w), max_abs(got, ref),
            lambda: attention.attention_qkv(qkv, heads, hd),
            lambda: attention.attention_qkv_reference(qkv, heads, hd),
            ({"bf16": 4 * nv * heads * 256 * 256 * hd},
             nbytes(qkv) + nbytes(got)),
            library={"SDPA": lambda: F.scaled_dot_product_attention(
                qv, kv_, vv)}, iters=5, twin_iters=2)
    del qkv, qv, kv_, vv

    # K13: LN + QKV (108544, 768) @ (768, 2304), out-proj + residual
    # (108544, 768) @ (768, 768), and the GELU epilogue at fc1's shape;
    # f32 sums in another order, one bf16 rounding of the output
    o = randn(m, w).to(bf)
    cases = [
        ("ln", x, fw["qkv_w"], qkv_b, dict(ln=ln_pair)),
        ("residual", o, fw["out_w"], out_b, dict(residual=x)),
        ("gelu", x, fw["fc1_w"], mlp_q["fc1_b"], dict(activation="gelu")),
    ]
    for form, a_in, wt, bias, kw in cases:
        got = linear.linear_fused(a_in, wt, bias, **kw)
        ref = linear.linear_fused_reference(a_in, wt, bias, **kw)
        torch.cuda.synchronize()
        check_close(f"K13 {form} {tuple(a_in.shape)}@{tuple(wt.shape)}", got,
                    ref, atol=1e-2, rtol=2 ** -7)
        wt_t = wt.t()
        bias16 = bias.to(bf)
        res = kw.get("residual")
        rec.add("K13", "linear_fused", (m, wt.shape[0], wt.shape[1], form),
                max_abs(got, ref),
                lambda: linear.linear_fused(a_in, wt, bias, **kw),
                lambda: linear.linear_fused_reference(a_in, wt, bias, **kw),
                ({"bf16": 2 * m * wt.shape[0] * wt.shape[1]},
                 nbytes(a_in, wt, bias, res, *(kw.get("ln") or ()))
                 + nbytes(got)),
                library={"part GEMM F.linear": lambda: F.linear(
                    a_in, wt_t, bias16)}, iters=10, twin_iters=3)
        del got, ref
    del o, cases

    # K14: (108544, 768) → fc1 3072 → fc2 768 + residual
    mp = {"fc1_w": fw["fc1_w"], "fc1_b": mlp_q["fc1_b"],
          "fc2_w": fw["fc2_w"], "fc2_b": mlp_q["fc2_b"]}
    ln2 = {"scale": ln1["scale"], "bias": ln1["bias"]}
    got = mlp.mlp_block_fused(x, ln2, mp)
    ref = mlp.mlp_block_reference(x, ln2, mp)
    torch.cuda.synchronize()
    check_close("K14 (108544, 768)", got, ref, atol=1e-2, rtol=2 ** -7)
    hid = randn(m, inter).to(bf)
    w1t, w2t = fw["fc1_w"].t(), fw["fc2_w"].t()
    b1, b2 = mp["fc1_b"].to(bf), mp["fc2_b"].to(bf)
    rec.add("K14", "mlp_block_fused", (m, w, inter), max_abs(got, ref),
            lambda: mlp.mlp_block_fused(x, ln2, mp),
            lambda: mlp.mlp_block_reference(x, ln2, mp),
            ({"bf16": 4 * m * w * inter},
             nbytes(x, ln2["scale"], ln2["bias"], *mp.values())
             + nbytes(got)),
            library={"part fc1 F.linear": lambda: F.linear(x, w1t, b1),
                     "part fc2 F.linear": lambda: F.linear(hid, w2t, b2)},
            iters=5, twin_iters=2)
    del x, fw, got, ref, hid
    torch.cuda.empty_cache()

    # K10: the backward of K9 at the MTL step's (16, 256, 2304) and at
    # S=32; P and dS are rounded to bf16 in both, the sums run in another
    # order: as K9, within atol 1e-2 + one bf16 step
    for b, s_ in ((MTL_BATCH, 256), (MTL_BATCH, 32)):
        qkv = randn(b, s_, 3 * w).to(bf)
        gout = randn(b, s_, w).to(bf)
        got = attention.attention_qkv_bwd(qkv, gout, heads, hd)
        ref = attention.attention_qkv_bwd_reference(qkv, gout, heads, hd)
        torch.cuda.synchronize()
        check_close(f"K10 {(b, s_, 3 * w)}", got, ref, atol=1e-2,
                    rtol=2 ** -7)
        qv, kv_, vv = (qkv[..., i * w:(i + 1) * w].reshape(b, s_, heads, hd)
                       .transpose(1, 2).detach().requires_grad_(True)
                       for i in range(3))
        go = gout.reshape(b, s_, heads, hd).transpose(1, 2)

        def sdpa_fwd():
            return F.scaled_dot_product_attention(qv, kv_, vv)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa_fwd(), (qv, kv_, vv), go)

        # the library's backward alone, on the card's clock: the device
        # time of forward + backward minus that of the forward (CUDA events
        # around these calls time the host's autograd call at this size)
        sdpa_bwd = device_ms(sdpa_fwd_bwd) - device_ms(sdpa_fwd)
        rec.add("K10", "attention_qkv_bwd", (b, s_, 3 * w),
                max_abs(got, ref),
                lambda: attention.attention_qkv_bwd(qkv, gout, heads, hd),
                lambda: attention.attention_qkv_bwd_reference(qkv, gout,
                                                              heads, hd),
                ({"bf16": 5 * 2 * s_ * s_ * hd * heads * b},
                 nbytes(qkv, gout) + nbytes(got)),
                library={"SDPA backward": sdpa_bwd})
    # the tower's differentiable attention: K9 forward + K10 backward in
    # one autograd Function, against the same Function through the twins
    qkv = randn(4, 256, 3 * w).to(bf)
    cot = randn(4, 256, w)
    grads = []
    for ks in (None, TWINS):
        x = qkv.clone().requires_grad_(True)
        kw = {} if ks is None else dict(fwd=ks.attention_qkv,
                                        bwd=ks.attention_qkv_bwd)
        o = attention.attention_qkv_vjp(x, heads, hd, **kw)
        (o.float() * cot).sum().backward()
        grads.append(x.grad)
    torch.cuda.synchronize()
    check_close("K9+K10 autograd Function vs twins (4, 256, 2304)", grads[0],
                grads[1], atol=1e-2, rtol=2 ** -7)
    print(f"  K9+K10 autograd Function gradient vs twins: max|Δ| "
          f"{max_abs(grads[0], grads[1]):.3e} [{card}]", flush=True)
    del qkv, gout, got, ref, qv, kv_, vv, go, grads, x, o, cot
    torch.cuda.empty_cache()

    clock("phase 2: K1-K4, K9-K14")

    # ---- K5-K8, the W8A8 block's other routes, at the detect core's shapes
    ln2 = {"scale": 1.0 + randn(w, std=0.1), "bias": randn(w, std=0.1)}
    bp8 = {"ln1": ln1, "ln2": ln2,
           "attn": {"qkv_w": qkv_wq, "qkv_b": qkv_b, "out_w": out_wq,
                    "out_b": out_b},
           "mlp": mlp_q,
           "act_scales": {"qkv": a_qkv, "out": a_out, "fc1": mlp_sc["fc1"],
                          "fc2": mlp_sc["fc2"]}}
    m = 8 * 256
    a8 = torch.randint(-127, 128, (m, w), generator=g, device=dev,
                       dtype=torch.int8)
    # K5 at the detect core's 2048 rows, timed, and at the row counts its
    # ToMe schedule gives it at B=8 (S = 160, 80, 40, 32) and B=256 (S=32)
    errs = []
    for b, s_ in ((8, 256), (8, 160), (8, 80), (8, 40), (8, 32), (256, 32)):
        x = randn(b, s_, w).to(bf)
        args = (x, ln1, qkv_wq, qkv_b, a_qkv)
        got = int8_block.ln_qkv_int8(*args)
        ref = int8_block.ln_qkv_reference(*args)
        check_close(f"K5 {(b * s_, w, 3 * w)}", got, ref, atol=5e-2,
                    rtol=2e-2)
        errs.append(f"S={s_} B={b} {max_abs(got, ref):.3e}")
        if (b, s_) != (8, 256):
            continue
        y16 = F.layer_norm(x, (w,), ln1["scale"].to(bf), ln1["bias"].to(bf),
                           1e-6)
        inv = 127.0 / a_qkv
        rec.add("K5", "ln_qkv_int8", (m, w, 3 * w), max_abs(got, ref),
                lambda: int8_block.ln_qkv_int8(*args),
                lambda: int8_block.ln_qkv_reference(*args),
                ({"int8": 2 * m * w * 3 * w},
                 nbytes(x, ln1["scale"], ln1["bias"], qkv_wq["q"],
                        qkv_wq["scale"], qkv_b, a_qkv) + nbytes(got)),
                library={
                    "part F.layer_norm": lambda: F.layer_norm(
                        x, (w,), ln1["scale"].to(bf), ln1["bias"].to(bf),
                        1e-6),
                    "part quant": lambda: torch.clamp(
                        torch.round(y16.float() * inv), -127, 127).to(
                            torch.int8),
                    "part QKV _int_mm": lambda: torch._int_mm(
                        a8, qkv_wq["qT"].t())}, device_time=True)
    torch.cuda.synchronize()
    print(f"  K5 at the ToMe row counts: max|Δ| {'; '.join(errs)} [{card}]",
          flush=True)

    # K6 at (8, 256, 2304) without a bias (one launch), and its biased route
    # (K9 + the out-proj GEMM) at the first ToMe count (8, 160)
    for b, s_, with_bias in ((8, 256, False), (8, 160, True)):
        qkv = randn(b, s_, 3 * w).to(bf)
        x = randn(b, s_, w).to(bf)
        lb = (torch.log(torch.randint(1, 9, (b, s_), generator=g,
                                      device=dev).float())
              if with_bias else None)
        args = (qkv, x, out_wq, out_b, a_out, heads, hd)
        LAUNCHES.reset()
        got = int8_block.attn_out_int8(*args, logit_bias=lb)
        ref = int8_block.attn_out_reference(*args, logit_bias=lb)
        torch.cuda.synchronize()
        launched = LAUNCHES.snapshot()
        want = ({attention.KERNEL: 1, quant.KERNEL_GEMM: 1} if with_bias
                else {int8_block.KERNEL_ATTN_OUT: 1})
        check_launches(f"K6 bias={with_bias}", launched, want)
        check_close(f"K6 {(b, s_, 3 * w)} bias={with_bias}", got, ref,
                    atol=5e-2, rtol=2e-2)
        if with_bias:
            print(f"  K6 biased route (K9 + out-proj GEMM) {(b, s_, 3 * w)}: "
                  f"max|Δ| {max_abs(got, ref):.3e} [{card}]", flush=True)
            continue
        q, k, v = (qkv[..., i * w:(i + 1) * w].reshape(b, s_, heads, hd)
                   .transpose(1, 2) for i in range(3))
        rec.add("K6", "attn_out_int8", (b, s_, 3 * w), max_abs(got, ref),
                lambda: int8_block.attn_out_int8(*args),
                lambda: int8_block.attn_out_reference(*args),
                ({"bf16": 4 * b * heads * s_ * s_ * hd,
                  "int8": 2 * b * s_ * w * w},
                 nbytes(qkv, x, out_wq["q"], out_wq["scale"], out_b, a_out)
                 + nbytes(got)),
                library={
                    "part attention SDPA":
                        lambda: F.scaled_dot_product_attention(q, k, v),
                    "part out-proj _int_mm": lambda: torch._int_mm(
                        a8, out_wq["qT"].t())}, device_time=True)

    def k7_faulty(x, bp):
        """K7's twin with a planted fault: the attention sublayer's
        residual rounded to bf16 before LN2 and the final add (the split
        kernels' order, not the whole-layer kernel's)."""
        b, s_, _ = x.shape
        sc, at = bp["act_scales"], bp["attn"]
        qkv = int8_block.ln_qkv_reference(x, bp["ln1"], at["qkv_w"],
                                          at["qkv_b"], sc["qkv"])
        o = attention.attention_qkv_reference(qkv, heads, hd,
                                              out_dtype=torch.float32)
        acc = quant.int8_mm(quant.quant_rows(o, sc["out"]).reshape(-1, w),
                            at["out_w"]["q"]).float()
        x1 = (x.float().reshape(-1, w)
              + acc * ((sc["out"] / 127.0) * at["out_w"]["scale"])
              + at["out_b"]).to(bf).reshape(b, s_, w)
        return mlp.mlp_block_int8_reference(
            x1, bp["ln2"], bp["mlp"], {"fc1": sc["fc1"], "fc2": sc["fc2"]})

    # K7 at (8, 256, 768) and (256, 32, 768): the layer against its twin
    # (within atol/rtol and at most K7_SHARE of outputs not bit-equal), and
    # the same checks must fail against the twin with the planted fault
    for b, s_ in ((8, 256), (256, 32)):
        x = randn(b, s_, w).to(bf)
        got = int8_block.siglip_layer_int8(x, bp8, heads, hd)
        ref = int8_block.siglip_layer_int8_reference(x, bp8, heads, hd)
        bad = k7_faulty(x, bp8)
        torch.cuda.synchronize()
        share = float((got != ref).float().mean())
        bad_share = float((got != bad).float().mean())
        check_close(f"K7 {(b, s_, w)}", got, ref, atol=5e-2, rtol=2e-2)
        print(f"  K7 {(b, s_, w)}: not bit-equal to the twin {share:.3e}, "
              f"to the twin with the mid-layer residual in bf16 "
              f"{bad_share:.3e} (max|Δ| {max_abs(got, bad):.3e}) [{card}]",
              flush=True)
        if share > K7_SHARE:
            raise AssertionError(f"K7 {(b, s_, w)}: {share:.3e} of the "
                                 f"outputs differ from the twin")
        if bad_share <= K7_SHARE:
            raise AssertionError("K7's checks miss a mid-layer residual "
                                 "rounded to bf16")
        mb = b * s_
        q, k, v = (randn(b, heads, s_, hd).to(bf) for _ in range(3))
        a8k = torch.randint(-127, 128, (mb, w), generator=g, device=dev,
                            dtype=torch.int8)
        h8 = torch.randint(-127, 128, (mb, inter), generator=g, device=dev,
                           dtype=torch.int8)
        rec.add("K7", "siglip_layer_int8", (b, s_, w), max_abs(got, ref),
                lambda: int8_block.siglip_layer_int8(x, bp8, heads, hd),
                lambda: int8_block.siglip_layer_int8_reference(x, bp8, heads,
                                                               hd),
                ({"int8": 2 * mb * w * (4 * w + 2 * inter),
                  "bf16": 4 * b * heads * s_ * s_ * hd},
                 nbytes(x, ln1["scale"], ln1["bias"], ln2["scale"],
                        ln2["bias"], qkv_wq["q"], qkv_wq["scale"], qkv_b,
                        out_wq["q"], out_wq["scale"], out_b,
                        mlp_q["fc1_w"]["q"], mlp_q["fc1_w"]["scale"],
                        mlp_q["fc1_b"], mlp_q["fc2_w"]["q"],
                        mlp_q["fc2_w"]["scale"], mlp_q["fc2_b"], a_qkv,
                        a_out, mlp_sc["fc1"], mlp_sc["fc2"]) + nbytes(got)),
                library={
                    "part QKV _int_mm": lambda: torch._int_mm(
                        a8k, qkv_wq["qT"].t()),
                    "part attention SDPA":
                        lambda: F.scaled_dot_product_attention(q, k, v),
                    "part out-proj _int_mm": lambda: torch._int_mm(
                        a8k, out_wq["qT"].t()),
                    "part fc1 _int_mm": lambda: torch._int_mm(
                        a8k, mlp_q["fc1_w"]["qT"].t()),
                    "part fc2 _int_mm": lambda: torch._int_mm(
                        h8, mlp_q["fc2_w"]["qT"].t())},
                iters=10, twin_iters=3, device_time=True)

    # K8 at (2048, 768): int8 codes equal to the twin's but at f32 LN ties
    x = (randn(m, w) * 3.0 + 0.5).to(bf)
    got = layernorm.layer_norm_quant(x, ln1["scale"], ln1["bias"], a_qkv)
    ref = layernorm.layer_norm_quant_reference(x, ln1["scale"], ln1["bias"],
                                               a_qkv)
    torch.cuda.synchronize()
    dq = (got.int() - ref.int()).abs()
    share = float((dq > 0).float().mean())
    print(f"  K8 {(m, w)}: codes differing from the twin's {share:.3e}, "
          f"max {int(dq.max())} [{card}]", flush=True)
    if got.dtype != torch.int8 or int(dq.max()) > 1 or share > K8_SHARE:
        raise AssertionError(f"K8 {(m, w)}: {share:.3e} of the codes differ, "
                             f"max by {int(dq.max())}")
    rec.add("K8", "layer_norm_quant", (m, w), float(dq.max()),
            lambda: layernorm.layer_norm_quant(x, ln1["scale"], ln1["bias"],
                                               a_qkv),
            lambda: layernorm.layer_norm_quant_reference(
                x, ln1["scale"], ln1["bias"], a_qkv),
            ({"f32": K8_OPS_PER_ELEMENT * x.numel()},
             nbytes(x, ln1["scale"], ln1["bias"], a_qkv) + nbytes(got)),
            library={"part F.layer_norm": lambda: F.layer_norm(
                x, (w,), ln1["scale"].to(bf), ln1["bias"].to(bf), 1e-6)},
            device_time=True)
    del x, got, ref, bad, qkv, q, k, v, a8, a8k, h8, y16
    torch.cuda.empty_cache()

    large_kernel_checks(rec, dev, card)
    lap("large_kernel_checks")
    plain_attention_checks(rec, dev, card)
    lap("plain_attention_checks")
    k10_long_checks(rec, dev, card)
    lap("k10_long_checks")
    probe_launches = probe_checks(rec, dev, card)
    lap("probe_checks")
    long_seq_checks(dev, card)
    lap("long_seq_checks")
    gemm_checks(dev, card)
    lap("gemm_checks")
    gemm_path_timings(dev, card)
    lap("gemm_path_timings")
    headdim_checks(dev, card)
    lap("headdim_checks")
    i8_gemm_checks(dev, card)
    lap("i8_gemm_checks")
    rec.note_gemm(i8_gemm_path_timings(dev, card))
    lap("i8_gemm_path_timings")
    rec.note_ln(ln_timings(dev, card))
    lap("ln_timings")
    k1_attention_checks(rec, dev, card)
    lap("k1_attention_checks")
    k5_9b_checks(rec, dev, card)
    lap("k5_9b_checks")
    k6_k7_checks(rec, dev, card)
    lap("k6_k7_checks")
    queue_launches = queue_c_checks(rec, dev, card)
    lap("queue_c_checks")
    k3_checks(rec, dev, card)
    lap("k3_checks")
    sm90_sass_checks(sass)
    lap("sm90 SASS (cuobjdump in the background since the build)")

    clock("phase 2: routes, probes, GEMMs, redesigns")

    # ---- 3a. the detect core
    print("phase 3: paths", flush=True)
    t0 = time.perf_counter()
    model = build(dev, seed=0)
    torch.cuda.synchronize()
    print(f"detect core: build (init + calibrate on 32 images + quantise) "
          f"{time.perf_counter() - t0:.2f} s [{card}]", flush=True)
    params = model.param_tree()
    expect = {int8_block.KERNEL: 12, mlp.KERNEL: 12, mlp.KERNEL_SUMSQ: 4,
              srm.KERNEL: 1, layernorm.KERNEL: 2}
    pg = torch.Generator(device=dev).manual_seed(2)
    core_launches = {}
    for b in (8, 256):
        px = torch.rand((b, 256, 256, 3), generator=pg,
                        device=dev).to(torch.bfloat16)
        LAUNCHES.reset()
        out = model(px)
        torch.cuda.synchronize()
        core_launches = LAUNCHES.snapshot()
        check_launches(f"detect core B={b}", core_launches, expect)
        for k, v in out.items():
            if not torch.isfinite(v).all():
                raise AssertionError(f"B={b}: {k} not finite")
        shapes = {k: tuple(v.shape) for k, v in out.items()}
        if shapes != {"p_blend": (b,), "risk_probs": (b, 5), "z_sig": (b,),
                      "z_freq": (b,)}:
            raise AssertionError(f"B={b}: shapes {shapes}")
        pb = out["p_blend"]
        if not ((pb >= 0) & (pb <= 1)).all():
            raise AssertionError(f"B={b}: p_blend outside [0, 1]")
        rs = out["risk_probs"].sum(-1)
        if not torch.allclose(rs, torch.ones_like(rs), atol=1e-5):
            raise AssertionError(f"B={b}: risk_probs rows do not sum to 1")
        kern = detect_core(params, px, model.cfg, model.cuts)
        twin = detect_core(params, px, model.cfg, model.cuts, kernels=TWINS)
        torch.cuda.synchronize()
        cos = F.cosine_similarity(kern["pooled"].float(),
                                  twin["pooled"].float(), dim=-1)
        dpb = float((kern["p_blend"] - twin["p_blend"]).abs().max())
        dmain = float((out["p_blend"] - kern["p_blend"]).abs().max())
        print(f"detect core B={b}: launches {core_launches}; pooled cosine "
              f"min {float(cos.min()):.6f} mean {float(cos.mean()):.6f}; "
              f"max|Δp_blend| twin {dpb:.3e}, repeat {dmain:.3e}; "
              f"p_blend mean {float(pb.float().mean()):.4f}", flush=True)
        if float(cos.min()) < 0.99 or dpb > 1e-2:
            raise AssertionError(f"B={b}: kernels vs twins disagree")

    clock("phase 3a")

    # ---- 3a'. the detect core under the W8A8 block's other routes: the
    # 12 layers run K5 (+ K6 at layer 0, where there is no ToMe bias; K9 +
    # the out-proj GEMM where there is), K8 + the int8 products + K9, or
    # FPP under LLL (JAX's K7 fits no layer: 14.0 MB at S = 256, and the
    # bias sends the others to FPP); 4 of the 12 feed a merge
    route_expect = {
        "PPP": {int8_block.KERNEL_LN_QKV: 12, int8_block.KERNEL_ATTN_OUT: 1,
                attention.KERNEL: 11, quant.KERNEL_GEMM: 11, mlp.KERNEL: 12,
                mlp.KERNEL_SUMSQ: 4, srm.KERNEL: 1, layernorm.KERNEL: 2},
        "XXX": {layernorm.KERNEL_QUANT: 24, quant.KERNEL_GEMM: 48,
                attention.KERNEL: 12, srm.KERNEL: 1, layernorm.KERNEL: 2},
        "LLL": {int8_block.KERNEL: 12, mlp.KERNEL: 12, mlp.KERNEL_SUMSQ: 4,
                srm.KERNEL: 1, layernorm.KERNEL: 2}}
    rg = torch.Generator(device=dev).manual_seed(5)
    route_launches, tower_launches = {}, {}

    try:
        for route in ROUTES:
            os.environ["TPUDF_INT8_KERNELS"] = route
            for b in (8, 256):
                px = torch.rand((b, 256, 256, 3), generator=rg,
                                device=dev).to(torch.bfloat16)
                LAUNCHES.reset()
                out = model(px)
                torch.cuda.synchronize()
                launched = LAUNCHES.snapshot()
                check_launches(f"detect core {route} B={b}", launched,
                               route_expect[route])
                for k, v in out.items():
                    if not torch.isfinite(v).all():
                        raise AssertionError(f"{route} B={b}: {k} not finite")
                kern = detect_core(params, px, model.cfg, model.cuts)
                LAUNCHES.reset()
                twin = detect_core(params, px, model.cfg, model.cuts,
                                   kernels=TWINS)
                torch.cuda.synchronize()
                if LAUNCHES.snapshot():
                    raise AssertionError(f"twins launched "
                                         f"{LAUNCHES.snapshot()}")
                print(f"detect core {route} B={b}: launches {launched}; "
                      + pooled_vs(f"detect core {route} B={b}",
                                  kern["pooled"], twin["pooled"],
                                  (kern["p_blend"], twin["p_blend"]))
                      + f"; p_blend mean "
                      f"{float(out['p_blend'].float().mean()):.4f} [{card}]",
                      flush=True)
            route_launches[route] = launched
        # the tower without ToMe at B=8: all 12 layers through K5 and K6
        # (their launches in the kernels line: the ToMe cores run one layer
        # or none through them), or under LLL through FPP (JAX's K7 does
        # not fit S = 256)
        norm = (px[:8] - 0.5) / 0.5
        for route, expect in (
                ("LLL", {int8_block.KERNEL: 12, mlp.KERNEL: 12,
                         layernorm.KERNEL: 2}),
                ("PPP", {int8_block.KERNEL_LN_QKV: 12,
                         int8_block.KERNEL_ATTN_OUT: 12, mlp.KERNEL: 12,
                         layernorm.KERNEL: 2})):
            os.environ["TPUDF_INT8_KERNELS"] = route
            with torch.no_grad():
                LAUNCHES.reset()
                kern = siglip_forward(params["backbone"], norm, model.cfg)
                torch.cuda.synchronize()
                launched = LAUNCHES.snapshot()
                check_launches(f"tower {route} without ToMe", launched,
                               expect)
                tower_launches[route] = launched
                twin = siglip_forward(params["backbone"], norm, model.cfg,
                                      kernels=TWINS)
            print(f"tower {route} without ToMe B=8: launches {launched}; "
                  + pooled_vs(f"tower {route}", kern["pooled"],
                              twin["pooled"]) + f" [{card}]", flush=True)
    finally:
        os.environ.pop("TPUDF_INT8_KERNELS", None)
    del kern, twin, out

    clock("phase 3a'")

    # ---- 3b/3c. the engines
    import dataclasses
    t0 = time.perf_counter()
    eng_a = build_engine(dev, seed=0)
    eng_b = build_engine(dev, seed=0, int8=True, tome=True, patch_tome=True)
    torch.cuda.synchronize()
    print(f"engines: build of A (bf16) and B (init + calibrate on 16 images "
          f"+ quantise) {time.perf_counter() - t0:.2f} s [{card}]", flush=True)
    twins = {"A": dataclasses.replace(eng_a, kernels=TWINS),
             "B": dataclasses.replace(eng_b, kernels=TWINS)}
    engines = {"A": eng_a, "B": eng_b}
    float_launches = {linear.KERNEL: 24, attention.KERNEL: 12,
                      mlp.KERNEL_BF16: 12, layernorm.KERNEL: 2,
                      srm.KERNEL: 1}
    base_expect = {
        ("A", "full"): float_launches,
        ("A", "fast"): float_launches,
        # two tower forwards: the 21 main views (r=96, floor 32) and the
        # 32 patch views (r=128, floor 16), each with 4 merges
        ("B", "full"): {int8_block.KERNEL: 24, mlp.KERNEL: 24,
                        mlp.KERNEL_SUMSQ: 8, layernorm.KERNEL: 4,
                        srm.KERNEL: 1},
    }
    rng = np.random.default_rng(3)
    requests = {("A", "full"): rng.integers(0, 256, (8, 256, 256, 3),
                                            np.uint8),
                ("A", "fast"): rng.integers(0, 256, (32, 256, 256, 3),
                                            np.uint8)}
    requests[("B", "full")] = requests[("A", "full")]
    engine_launches = {}
    for (e, mode), px in requests.items():
        engine_launches[(e, mode)] = engine_request(
            f"engine {e} {mode}", engines[e], twins[e], px, mode == "fast",
            e == "B", base_expect[(e, mode)], w)

    clock("phase 3b/3c")

    # ---- 3d. the MTL trainer: (a) float prefix, (b) int8 prefix
    bg = torch.Generator(device=dev).manual_seed(4)
    mtl_batches = []
    for _ in range(MTL_STEPS):
        masks = torch.zeros((MTL_BATCH, 256, 256), device=dev)
        for i in range(MTL_BATCH):
            y0, x0 = torch.randint(0, 192, (2,), generator=bg, device=dev)
            masks[i, y0:y0 + 64, x0:x0 + 64] = 1.0
        mtl_batches.append({
            "pixels": torch.rand((MTL_BATCH, 256, 256, 3), generator=bg,
                                 device=dev) * 2 - 1,
            "cls": torch.randint(0, 3, (MTL_BATCH,), generator=bg,
                                 device=dev),
            "mask": masks,
            "has_mask": (torch.rand((MTL_BATCH,), generator=bg, device=dev)
                         < 0.5).float()})
    float_step = {linear.KERNEL: 24, attention.KERNEL: 12,
                  mlp.KERNEL_BF16: 12, layernorm.KERNEL: 2,
                  attention.KERNEL_BWD: 3}
    mtl_expect = {
        "a": float_step,
        # the 9 frozen layers on K1/K2, the 3 trainable ones on K13/K9/K14
        "b": {int8_block.KERNEL: MTL_FREEZE, mlp.KERNEL: MTL_FREEZE,
              linear.KERNEL: 6, attention.KERNEL: 3, mlp.KERNEL_BF16: 3,
              layernorm.KERNEL: 2, attention.KERNEL_BWD: 3}}

    mtl_tree = mtl_params(dev, seed=0)      # the CLI's seed-0 init

    def trainer(cfg_key, kernels=KERNELS):
        return build_mtl_trainer(fresh(mtl_tree), freeze_below=MTL_FREEZE,
                                 int8_frozen=cfg_key == "b", lr=MTL_LR,
                                 warmup_steps=1,
                                 calib_pixels=mtl_batches[0]["pixels"],
                                 kernels=kernels)

    def train_run_(cfg_key, ks, label):
        return train_run(trainer, cfg_key, ks, label, mtl_batches,
                         MTL_FREEZE, dev, card)

    def fault_checks(twin):
        """The checks below against a planted fault: K10 with its dQ, dK or
        dV third zeroed must fail them, against the same twins' run of
        (a)."""
        for j, part in enumerate("QKV"):
            def faulty_bwd(qkv, g, heads_, head_dim, scale=None, j=j):
                d = attention.attention_qkv_bwd(qkv, g, heads_, head_dim,
                                                scale)
                d[..., j * w:(j + 1) * w] = 0
                return d

            label = f"(a) K10 with d{part} zeroed"
            bad = train_run_("a", dataclasses.replace(
                KERNELS, attention_qkv_bwd=faulty_bwd), label)
            dloss, cos, g_worst, p_worst = versus(bad, twin)
            print(report(label, dloss, cos, g_worst, p_worst, card),
                  flush=True)
            if g_worst[1] <= MTL_GRAD_ERR or p_worst[1] <= MTL_PARAM_LR:
                raise AssertionError(f"trainer: the kernels-vs-twins check "
                                     f"misses K10 with d{part} zeroed")

    mtl_launches = {}
    for cfg_key in ("a", "b"):
        kern = train_run_(cfg_key, KERNELS, f"({cfg_key}) kernels")
        for i, launches in enumerate(kern[3]):
            check_launches(f"trainer ({cfg_key}) step {i}", launches,
                           mtl_expect[cfg_key])
        mtl_launches[cfg_key] = kern[3][0]
        twin = train_run_(cfg_key, TWINS, f"({cfg_key}) twins")
        if any(twin[3]):
            raise AssertionError(f"twins launched {twin[3]}")
        dloss, cos, g_worst, p_worst = versus(kern, twin)
        print(f"trainer ({cfg_key}): launches per step "
              f"{mtl_launches[cfg_key]}", flush=True)
        print(report(f"({cfg_key})", dloss, cos, g_worst, p_worst, card),
              flush=True)
        if (max(dloss) > MTL_DLOSS[cfg_key] or min(cos.values()) < 0.99
                or g_worst[1] > MTL_GRAD_ERR or p_worst[1] > MTL_PARAM_LR):
            raise AssertionError(f"trainer ({cfg_key}): kernels vs twins "
                                 f"disagree")
        del kern
        if cfg_key == "a":
            fault_checks(twin)
        del twin

    clock("phase 3d")

    # ---- 3s. the MTL CLI's default route: SID_Set through a stand-in
    # `datasets` module, float and --int8_frozen, each step launching 3d's
    sid_tmp = tempfile.TemporaryDirectory()
    sid_paths(dev, card, sid_tmp.name, mtl_expect)
    sid_tmp.cleanup()

    clock("phase 3s")

    # ---- 3e-3g. the large backbones: detect cores, routes, engines
    large = large_paths(dev, card)

    clock("phase 3e-3g")

    # ---- 3r. the image report on both backbones' engines
    large_engines = large["engines"][0]
    report_backbones = {
        "base-256": (engines, engine_expect(eng_a.cfg.layers, 256), None),
        "large-384": (large_engines,
                      engine_expect(large_engines["A"].cfg.layers,
                                    LARGE["large-384"][5]), 2)}
    reports = report_paths(dev, card, report_backbones)

    clock("phase 3r")

    # ---- 3v. the video report on the same engines
    videos = video_paths(dev, card, report_backbones)

    clock("phase 3v")

    # ---- 3i / 3u. the front doors: the inference CLI at base-256 (W8A8 +
    # ToMe + patch ToMe), then the app's callbacks, the forensic maps and
    # the forensics CLI on its engine (cuDNN's TF32 at PyTorch's default:
    # the tail and the maps keep their f32 math themselves)
    front_tmp = tempfile.TemporaryDirectory()
    prev_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        cli = cli_paths(dev, card, front_tmp.name)
        clock("phase 3i")
        app_paths(dev, card, front_tmp.name, cli)
    finally:
        torch.backends.cudnn.allow_tf32 = prev_tf32
    del cli
    front_tmp.cleanup()
    torch.cuda.empty_cache()

    clock("phase 3u")

    # ---- 3w. weights in, large-384 MTL at 256 px, the multi-query _mha,
    # so400m's engines and int8 trees (the checkpoint lives in tmp until
    # phase 4 has timed the trainer built from it)
    tmp = tempfile.TemporaryDirectory()
    weights = weights_paths(dev, card, mtl_batches, tmp.name)

    clock("phase 3w")

    # ---- 3t. training at the large backbones: large-384 MTL at 384 px,
    # so400m-512 MTL, the binary trainer and its CLI
    rest = training_rest(dev, card, tmp.name)

    clock("phase 3t")

    # ---- 3x. the trainers: the experts CLI, the video CLI (bf16 and W8A8)
    # and the face nets' pretraining against their CPU runs
    trainers = trainer_paths(dev, card, tmp.name)

    clock("phase 3x")

    # ---- 3p. data- and tensor-parallel scale-out: p1 (a world of 1 on
    # NCCL) in this process, p2 / p3 (gloo worlds of ranks on this card)
    # started by torchrun
    par = parallel_paths(dev, card, tmp.name, engines["B"])

    clock("phase 3p")

    # ---- 4. timings of the paths
    print("phase 4: path timings", flush=True)
    for b, iters in ((8, 20), (256, 5)):
        px = torch.rand((b, 256, 256, 3), generator=pg,
                        device=dev).to(torch.bfloat16)
        fwd_ms, fwd_plain = paired_ms(
            lambda: model(px),
            lambda: detect_core(params, px, model.cfg, model.cuts,
                                kernels=TWINS), iters=iters)
        print(f"detect core B={b}: kernels {fwd_ms:.3f} ms = "
              f"{b * 1e3 / fwd_ms:.1f} img/s; twins {fwd_plain:.3f} ms = "
              f"{b * 1e3 / fwd_plain:.1f} img/s [{card}]", flush=True)
    profile(lambda: model(px), "detect core B=256", card)
    lap("timing detect core")
    try:
        # the opt-in routes at B = 256, kernels only (the twins' core is
        # the same under every route: timed above)
        px = torch.rand((256, 256, 256, 3), generator=pg,
                        device=dev).to(torch.bfloat16)
        for route in ROUTES:
            os.environ["TPUDF_INT8_KERNELS"] = route
            fwd_ms = cuda_ms(lambda: model(px), iters=5)
            print(f"detect core {route} B=256: kernels {fwd_ms:.3f} ms = "
                  f"{256e3 / fwd_ms:.1f} img/s [{card}]", flush=True)
        lap("timing routes")
        # the towers without ToMe at B = 8: 12 K6 launches (PPP), the FPP
        # layer (LLL, where JAX's K7 does not fit)
        norm = torch.rand((8, 256, 256, 3), generator=pg, device=dev).to(
            torch.bfloat16) * 2 - 1
        for route in ("PPP", "LLL"):
            os.environ["TPUDF_INT8_KERNELS"] = route
            tower_timing(lambda: siglip_forward(params["backbone"], norm,
                                                model.cfg),
                         f"tower base-256 {route} without ToMe B=8", card)
    finally:
        os.environ.pop("TPUDF_INT8_KERNELS", None)
    del model, params
    lap("timing towers without ToMe")

    for (e, mode), px in requests.items():
        eng, tw, fast = engines[e], twins[e], mode == "fast"
        b = px.shape[0]
        k_ms, t_ms = paired_ms(
            lambda: eng.fetch_batch(eng.dispatch_batch(px, fast), fast),
            lambda: tw.fetch_batch(tw.dispatch_batch(px, fast), fast),
            iters=5, twin_iters=2)
        print(f"engine {e} {mode} B={b}: kernels {k_ms:.3f} ms = "
              f"{b * 1e3 / k_ms:.1f} img/s; twins {t_ms:.3f} ms = "
              f"{b * 1e3 / t_ms:.1f} img/s [{card}]", flush=True)
    px = requests[("A", "full")]
    profile(lambda: eng_a.fetch_batch(eng_a.dispatch_batch(px)),
            "engine A full analysis B=8", card, top=16)
    clock("phase 4: detect core, routes, engines")
    report_timings(reports, card)
    clock("phase 4: image report")
    video_timings(videos, card)
    clock("phase 4: video report")

    print(f"peak device memory of this script so far "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")

    # the train steps, kernels vs twins (each step updates its state)
    def run(box):
        box["state"], _ = box["step"](box["state"], mtl_batches[0], None,
                                      1.0, 0.5)

    for cfg_key in ("a", "b"):
        state, step, _ = trainer(cfg_key)
        boxes = {"kernels": {"state": state, "step": step}}
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        run(boxes["kernels"])
        torch.cuda.synchronize()
        print(f"train step ({cfg_key}): peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, of "
              f"which {resident / 2**30:.2f} GiB resident before the step "
              f"(parameters, AdamW moments, the first batch) [{card}]",
              flush=True)
        state, step, _ = trainer(cfg_key, TWINS)
        boxes["twins"] = {"state": state, "step": step}
        del state, step
        k_ms, t_ms = paired_ms(lambda: run(boxes["kernels"]),
                               lambda: run(boxes["twins"]), iters=5,
                               twin_iters=3)
        print(f"train step ({cfg_key}) B={MTL_BATCH}: kernels {k_ms:.3f} ms = "
              f"{MTL_BATCH * 1e3 / k_ms:.1f} img/s; twins {t_ms:.3f} ms = "
              f"{MTL_BATCH * 1e3 / t_ms:.1f} img/s [{card}]", flush=True)
        if cfg_key == "a":
            profile(lambda: run(boxes["kernels"]),
                    f"train step ({cfg_key}) B={MTL_BATCH}", card, top=16)
        del boxes
        torch.cuda.empty_cache()

    clock("phase 4: train steps")
    print("phase 4: K9, K10, kernels 11 and 12 at the paths' shapes beside "
          "SDPA", flush=True)
    attention_factors(rec, card)
    clock("phase 4: attention factors")
    large_timings(large, card)
    clock("phase 4: large backbones")
    weights_timings(weights, card, mtl_batches)
    clock("phase 4: weights in")
    training_rest_timings(rest, card)
    clock("phase 4: large trainers")
    trainer_timings(trainers, card)
    clock("phase 4: trainers")
    parallel_timings(par, card)
    clock("phase 4: parallel")
    tmp.cleanup()

    names = {"K1": int8_block.KERNEL, "K2": mlp.KERNEL, "K3": srm.KERNEL,
             "K4": layernorm.KERNEL, "K5": int8_block.KERNEL_LN_QKV,
             "K6": int8_block.KERNEL_ATTN_OUT,
             "K7": int8_block.KERNEL_LAYER, "K8": layernorm.KERNEL_QUANT,
             "K9": attention.KERNEL, "K10": attention.KERNEL_BWD,
             "K13": linear.KERNEL, "K14": mlp.KERNEL_BF16,
             "K9b": attention.KERNEL_INT8, "K11": attention.KERNEL_PLAIN,
             "K12": attention.KERNEL_BSHD}
    engine_a = engine_launches[("A", "full")]
    # per run of the path each kernel serves: a detect-core forward (K5-K8:
    # under the route that runs them), engine A's full analysis, a train
    # step of (a)
    # 9b: so400m-512's tower under PPP without ToMe, TPUDF_INT8_ATTN=1
    # 11, 12: (w3)'s multi-query _mha at large-384's width
    # K6: base-256's tower without ToMe under PPP (phase 4 times it); K7:
    # the queue's base-256 block at S = 64 under LLL (phase 2m; JAX's K7
    # fits no layer of the detect cores)
    route_of = {"K5": "PPP", "K6": "PPP", "K8": "XXX"}
    launches = {k: (core_launches if k in ("K1", "K2", "K3", "K4")
                    else queue_launches if k == "K7"
                    else tower_launches[route_of[k]] if k == "K6"
                    else route_launches[route_of[k]] if k in route_of
                    else mtl_launches["a"] if k == "K10"
                    else large["launches"][("so400m-512", "PPP", True)]
                    if k == "K9b"
                    else weights["launches"][("w3", LARGE["large-384"][0])]
                    if k in ("K11", "K12") else engine_a)[n]
                for k, n in names.items()}
    launches.update(probe_launches)      # 15-17: each probe's main() run
    # the split forms: the queue's block (phase 2m) under LLL and PPP
    launches.update({k: queue_launches.get(n, 0) for k, n in (
        ("K5-split", int8_block.KERNEL_LN_QKV_SPLIT),
        ("K6-split", int8_block.KERNEL_ATTN_OUT_SPLIT),
        ("K7-split", int8_block.KERNEL_LAYER_SPLIT))})
    print(rec.line(launches))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if "--parallel-rank" in sys.argv:
        sys.exit(parallel_rank_main(sys.argv[1:]))
    sys.exit(main())
