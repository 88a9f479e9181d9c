#!/bin/bash
# Planted-fault check of chip_smoke.py's tolerances (needs one CUDA GPU).
#
#     bash scripts/chip_smoke_faults.sh OUT_DIR [FAULT ...]
#     bash scripts/chip_smoke_faults.sh --check-anchors [FAULT ...]
#
# Runs chip_smoke.py on the tree as it is, then on a temporary copy of the
# port with each fault below planted (one sed edit each; --steps 2, or
# --steps $FAULT_STEPS where that is set; $SMOKE_ARGS, e.g.
# --only-distributed for F42-F45, --only-drivers for F55-F58 or --only-fp32
# for F59-F67, is added to
# every run), or only with the
# faults named (e.g. F9_kl_skip), and
# writes one log per run to OUT_DIR. Every run prints all its readings, so
# the logs show where each limit sits between the sound tree and the
# faults. A fault run is expected to exit non-zero; the sound run, zero.
# Exits 0 when that holds for every run, else 1.
#
# --check-anchors applies every fault's edits to a temporary copy of the
# files they patch and exits 1 if one of them changes nothing (a stale
# anchor), without a GPU and without running chip_smoke.py.
#
#   F1_rowsum     flash forward divides o by 1.01 x the row sum (lse2 kept)
#   F2_skip_tile  flash backward skips key block 1 (its dk, dv stay zero;
#                 dq misses its part)
#   F3_dq_tile    flash backward drops only key block 1's part of dq (its
#                 16-byte atomics into the fp32 dq)
#   F4_conv_halo  conv kernel applies the input mask (in shared memory) to
#                 the tile's own rows but not to its halo rows
#   F5_d512_rowsum    d=512 flash forward divides o by 1.01 x the row sum
#   F6_d512_skip_tile d=512 flash backward skips key block 1 (dk, dv zero
#                 there; dq misses its part)
#   F7_epilogue_norm  guidance epilogue drops the eps-norm gradient rescale
#   F8_swap_dkdv      the flash autograd.Function returns dv as dk and dk as dv
#   F9_kl_skip        conv3x3_fused drops the residual (skip) of the KL
#                     ResNets (no ReLU), forward and backward
#   F10_kl_dskip      the conv autograd.Function gives the KL ResNets'
#                     residual (skip) no gradient
#   F11_ring_rescale  the ring's forward step does not rescale the carried
#                     acc by alpha at its first key tile (the state of the
#                     blocks before is added unscaled)
#   F12_ring_dkv_home the ring's backward leaves out dk|dv's last rotation
#                     (each shard keeps its neighbour's block gradients)
#   F13_ring_own_stat the ring's backward feeds each block's own o and lse2
#                     (recomputed by the plain forward) in place of the
#                     global ones (di from the first block's own o)
#   F14_ring_no_norm  the ring's last forward step writes acc without
#                     dividing by the row sum l; the backward gets that o
#   F15_twostream_alpha the two-stream flash forward's second stream skips
#                     the alpha rescale of its accumulator
#   F16_n64_c_half    probe variant C (sum/diff) without its 0.5
#   F17_block_step_max the block-step probe's full mode (WMMA design) takes
#                     p = exp2(s), without the running max
#   F18_fwd_alpha flash forward (d=64) skips the α rescale of its register
#                 o accumulator
#   F19_conv_co_tile  conv kernel reads weights and bias by the tile-local
#                 output channel (wrong only where Co spans two or more tiles)
#   F20_bwd_di    flash backward (d=64) forms ds = p·dp·scale in its
#                 registers, without subtracting di
#   F21_d512_alpha d=512 flash forward skips the α rescale of its register
#                 o accumulator
#   F22_ring_dkv_store the ring's backward step stores its dk|dv block over
#                 the travelling fp32 buffer instead of adding into it
#   F23_d512_dq_tile d=512 flash backward drops key tile 1's part of dq
#                 (its dq kernel zeroes ds there)
#   F24_epilogue_own_norms each block of the epilogue's cluster takes only
#                 its own partial norms, not the sample's
#   F25_loader_transpose the port's checkpoint loader transposes conv
#                 kernels (OIHW → HWIO) as the JAX package's converter does
#   F26_cli_depth_scale the CLI's to_depth scales the sparse PNG's bytes by
#                 255/max_sparse_depth in place of max_sparse_depth/255
#   F27_png_bgr   the PNG decoder hands RGB images over in BGR order
#   F28_conv_dx_nomask the conv Function's dx (every decoder backward, the
#                 per-input steps' too) takes no ReLU mask
#   F29_remat_skips_detached the UNet's up stages take their skips detached
#                 when rematerialised (the forward unchanged, no gradient
#                 into the down path through the skips)
#   F30_ensemble_lower_median the ensemble's median takes the lower middle
#                 member at an even count (torch.median's rule)
#   F31_serve_row_shift the serving engine's finisher hands row i's result
#                 to request i+1 of the batch
#   F32_fast_guidance_graph fast guidance runs the UNet with a graph again
#                 (and the gradient through it: flash_bwd launches)
#   F33_serve_zero_pad the serving engine pads a batch's images with zeros
#                 where the JAX engine pads with copies of row 0
#   F34_idct_round the JPEG decoder's second IDCT pass shifts without its
#                 rounding term
#   F35_h2v2_replicate the JPEG decoder upsamples h2v2 chroma by
#                 replication instead of the triangle filter
#   F36_bl2_unshuffle_ts1 the .bl2 reader unshuffles with typesize 1
#   F37_bl2_shape_reversed the .bl2 writer records the shape reversed in
#                 __pack_tensor__
#   F38_step_not_advanced the step program does not advance its step index
#                 before a replay (every replay runs the step of the last
#                 eager step)
#   F39_epilogue_row0 the epilogue kernel reads row 0 of its scalar table
#                 whatever the step index
#   F40_replay_uncounted replays add no launches to the wrappers' counts
#   F41_stale_adam a request does not reset the latent's Adam m and v in
#                 the step program's buffers
#   F42_geglu_contiguous tensor parallelism slices a GEGLU proj_in as one
#                 contiguous block (rank 0 only values at M=2), not matching
#                 slices of its value and gate halves
#   F43_tp_no_entry the tensor-parallel pairs' entry op passes the gradient
#                 through without its all_reduce (each rank's latent gradient
#                 is partial)
#   F44_fan_in_bias_each_rank a fan-in layer (to_out, proj_out, conv2) adds
#                 its bias on every rank, before the all_reduce
#   F45_ensemble_local_rows an ensemble's data rank draws its rows' member
#                 noise and frames by local row index, not global
#   F46_lcm_stale_renoise the LCM program keeps the re-noise table of the
#                 seed it was made with (a request of another seed re-noises
#                 with the first one's draws)
#   F47_per_input_adam_row per-input training reads Adam's bias-correction
#                 row of the next train step (the last step's row at the end)
#   F48_general_no_rescale the general per-step program (SGD, Adagrad, Adam
#                 without the epilogue) drops the eps-norm gradient rescale
#   F49_finish_before_last_step on the graph path the finish graph is
#                 replayed before the last step's replay (it decodes the
#                 latent one step short; the latent itself ends right)
#   F50_cmyk_no_k the JPEG decoder's CMYK->BGR conversion drops the K
#                 term (each channel is its inverted sample)
#   F51_bl2_blosclz_codec the .bl2 writer's blosclz chunks name LZ4 in their
#                 header (their streams are blosclz)
#   F52_smooth_complete the JPEG decoder block-smooths complete progressive
#                 files too, estimating every zero coefficient 1-9
#   F53_rle_delta_no_move the BMP decoder's RLE8 delta escape does not move
#                 the cursor
#   F54_verify_launch_count scripts/verify_checkpoint_torch.py prints one
#                 conv3x3 launch more than its request made
#   F55_frontier_chained_ref scripts/frontier_torch.py takes each mode's
#                 drift against the mode before it, not against full-50
#   F56_ring_lse_nats the ring's autograd.Function saves its log-sum-exp in
#                 nats for the backward, where the step kernels take log2
#                 (kitti-native-ring1 against kitti-native)
#   F57_kitti_first_as_steady scripts/bench_kitti_torch.py reads the first
#                 batch's time/infer (its programs' capture) as the steady one
#   F58_scaling_unsynced scripts/drivers_torch.py stops a timed request's
#                 clock without a synchronize (it times the enqueue; the
#                 drivers' shared loop, which bench_scaling's rows take)
#   F59_fp32_one_pass the fp32 kernels (flash, conv) take one TF32 pass
#                 per product in place of 3xTF32 (csrc/mma_sync.cuh's
#                 mma_tf32x3, which every fp32 flash product runs, and the
#                 conv's three wgmma products a tap: hi·hi' alone)
#   F60_fp32_as_bf16 the flash forward wrapper casts fp32 operands to bf16
#                 and runs the bf16 kernel
#   F61_d128_heads_as_d64 the generic flash forward at d=128 strides its
#                 query heads as d=64
#   F63_xch_own_slice the generic flash forward's warps that split o's
#                 channels (bf16 d >= 256, fp32 d >= 128) each add their own
#                 partial scores W times in place of the row group's W
#                 partials
#   F64_pv_keys_unpermuted the generic fp32 forward stores v's planes with
#                 the keys in their own order, so that p·v's B fragment holds
#                 keys t and t + 4 where p's A fragment holds 2t and 2t + 1
#   F62_fp32_conv_plain the conv wrapper computes its plain twin for an
#                 fp32 CUDA tensor (caught by the launch counts)
#   F65_conv_halo_lo_dropped the fp32 conv's split writes zeros for the
#                 halo's lo plane (x's TF32 remainder: two of the three
#                 products, x in one TF32 pass)
#   F66_conv_tap_shift the fp32 conv's A descriptor of the right-hand taps
#                 (kw = 2) starts one pixel short (kw = 1's pixels)
#   F67_route_skip_library the routed conv sends every conv with a skip (the
#                 KL ResNets' second, TAESD's third) to F.conv2d where the
#                 kernel fits: the same function, other launch counts
set -u
check=0
if [ "${1:-}" = "--check-anchors" ]; then
  check=1
  shift
else
  out=${1:?usage: scripts/chip_smoke_faults.sh OUT_DIR|--check-anchors [FAULT ...]}
  shift
fi
only=" $* "
cd "$(dirname "$0")/.."
status=0
if [ $check = 0 ]; then
  mkdir -p "$out"
  out=$(cd "$out" && pwd)
  nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
  python3 chip_smoke.py ${SMOKE_ARGS:-} > "$out/sound.log" 2>&1
  rc=$?
  echo "sound rc=$rc"
  [ $rc = 0 ] || status=1
fi

work=$(mktemp -d "${TMPDIR:-/tmp}/chip_smoke_faults.XXXXXX")
trap 'rm -rf "$work"' EXIT
FA=depth_completion_tpu_torch/csrc/flash_attention.cu
CONV=depth_completion_tpu_torch/csrc/conv3x3.cu
RING=depth_completion_tpu_torch/ops/ring_attention.py
PROBES=depth_completion_tpu_torch/probes

run_fault() {  # name, then (file, sed expression) pairs
  local name=$1 d="$work/$1"
  shift
  if [ "$only" != "  " ] && [[ "$only" != *" $name "* ]]; then
    return 0
  fi
  mkdir -p "$d"
  if [ $check = 0 ]; then
    cp -r chip_smoke.py depth_completion_tpu_torch "$d"/
    rm -rf "$d/depth_completion_tpu_torch/_build"
    mkdir -p "$d/tests/data" "$d/scripts"
    cp -r tests/data/torch_io "$d/tests/data/"  # the host IO phase's fixtures
    # phase 3a's checkpoint writer, phase 3b's verifier and phase 8's drivers
    cp scripts/make_synthetic_checkpoint_torch.py scripts/verify_checkpoint_torch.py \
      scripts/drivers_torch.py scripts/bench_nativeres_torch.py scripts/frontier_torch.py \
      scripts/bench_kitti_torch.py scripts/bench_scaling_torch.py "$d/scripts/"
  fi
  while [ $# -gt 0 ]; do
    local before
    if [ ! -e "$d/$1" ]; then
      mkdir -p "$(dirname "$d/$1")"
      cp "$1" "$d/$1"
    fi
    before=$(md5sum < "$d/$1")
    sed -i "$2" "$d/$1"
    if [ "$before" = "$(md5sum < "$d/$1")" ]; then
      echo "$name: the edit did not apply to $1"
      status=1
      return 1
    fi
    shift 2
  done
  if [ $check = 1 ]; then
    echo "$name: edits apply"
    return 0
  fi
  (cd "$d" && python3 chip_smoke.py --steps "${FAULT_STEPS:-2}" ${SMOKE_ARGS:-}) > "$out/$name.log" 2>&1
  local rc=$?
  echo "$name rc=$rc"
  [ $rc != 0 ] || status=1
}

run_fault F1_rowsum $FA 's|1.f / l0;|1.f / (1.01f * l0);|; s|1.f / l1;|1.f / (1.01f * l1);|'
run_fault F2_skip_tile \
  $FA 's|const int k0 = blockIdx.x \* BR, h = blockIdx.y, n = blockIdx.z;|&\n  if (blockIdx.x == 1) return;|' \
  depth_completion_tpu_torch/ops/flash_attention.py 's|torch.empty((n, sk, c)|torch.zeros((n, sk, c)|g'
run_fault F3_dq_tile $FA 's|if (row < sq) atomicAdd|if (row < sq \&\& blockIdx.x != 1) atomicAdd|'
run_fault F4_conv_halo $CONV \
  's|const uint4 val = mask_vec(xv, mv);|const uint4 val = (rr >= 1 \&\& rr <= TH) ? mask_vec(xv, mv) : xv;|'
run_fault F5_d512_rowsum $FA \
  's|const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;|const float inv0 = 1.f / (1.01f * sum0), inv1 = 1.f / (1.01f * sum1);|'
run_fault F6_d512_skip_tile \
  $FA 's|const int k0 = blockIdx.x \* BK5, h = blockIdx.y, n = blockIdx.z;|&\n  if (blockIdx.x == 1) return;|' \
  depth_completion_tpu_torch/ops/flash_attention.py 's|torch.empty((n, sk, c)|torch.zeros((n, sk, c)|g'
run_fault F7_epilogue_norm depth_completion_tpu_torch/csrc/guidance_epilogue.cu \
  's|const float factor = sqrtf(e2) / fmaxf(sqrtf(g2), 1e-7f);|const float factor = 1.f;|'
run_fault F8_swap_dkdv depth_completion_tpu_torch/ops/flash_attention.py \
  's|return dq, dk, dv, None|return dq, dv, dk, None|'
run_fault F9_kl_skip depth_completion_tpu_torch/ops/conv3x3.py \
  's|return Conv3x3Fused.apply(x, weight, bias, skip, relu)|return Conv3x3Fused.apply(x, weight, bias, skip if relu else None, relu)|'
run_fault F10_kl_dskip depth_completion_tpu_torch/ops/conv3x3.py \
  's|dskip = dy_m if (need_skip and ctx.has_skip) else None|dskip = dy_m if (need_skip and ctx.has_skip and ctx.relu) else None|'
run_fault F11_ring_rescale $FA \
  's|    rescale(acc, alpha0, alpha1);|    if (!(StateIn \&\& j == 0)) rescale(acc, alpha0, alpha1);|'
run_fault F12_ring_dkv_home $RING \
  's|        state = (di, dq, ring.shift(dkv))|        state = (di, dq, dkv if step == ring.size - 1 else ring.shift(dkv))|'
run_fault F13_ring_own_stat $RING \
  's|^    flash_bwd_ring_plain,$|&\n    flash_fwd_plain,|; s|        di, dq, dkv = step_bwd(|        o, lse2 = flash_fwd_plain(q, kv[..., :c], kv[..., c:], num_heads); &|'
run_fault F14_ring_no_norm $FA \
  's|const float inv0 = l0 == 0.f ? 1.f : 1.f / l0;|const float inv0 = StateIn ? 1.f : (l0 == 0.f ? 1.f : 1.f / l0);|; s|const float inv1 = l1 == 0.f ? 1.f : 1.f / l1;|const float inv1 = StateIn ? 1.f : (l1 == 0.f ? 1.f : 1.f / l1);|'
run_fault F15_twostream_alpha depth_completion_tpu_torch/csrc/probe_flash_twostream.cu \
  's|o_w\[r \* LDF + c\([01]\)\] \*= alpha;|if (warp < TS_WARPS / 2) &|'
run_fault F16_n64_c_half $PROBES/mma_n64.py \
  's|p_diff, torch.cat(\[v1, -v2\], 2), False, 0.5)|p_diff, torch.cat([v1, -v2], 2), False, 1.0)|'
run_fault F17_block_step_max depth_completion_tpu_torch/csrc/probe_block_step.cu \
  's|exp2f(s\([01]\) - m_new)|exp2f(s\1 - (MODE == FULL ? 0.f : m_new))|g'
run_fault F18_fwd_alpha $FA 's|rescale(acc, alpha0, alpha1);||'
run_fault F19_conv_co_tile $CONV \
  's|) \* Co + co0 + nv \* 8|) * Co + nv * 8|; s|bias\[co0 + co|bias[co|g'
run_fault F20_bwd_di $FA \
  's|dp\[i\]\[e\] = p \* (dp\[i\]\[e\] - ((e \& 1) ? dis.y : dis.x)) \* scale;|dp[i][e] = p * dp[i][e] * scale;|'
run_fault F21_d512_alpha $FA 's|rescale(o_acc, alpha0, alpha1);||'
run_fault F22_ring_dkv_store $FA \
  's|atomicAdd(reinterpret_cast<float2\*>(p), make_float2(x, y));|*reinterpret_cast<float2*>(p) = make_float2(x, y);|'
run_fault F23_d512_dq_tile $FA \
  's|s\[i\]\[e\] = pe \* (da\[e\]|s[i][e] = (j == 1 ? 0.f : pe) * (da[e]|'
run_fault F24_epilogue_own_norms depth_completion_tpu_torch/csrc/guidance_epilogue.cu \
  's|const float2 p = lane < CLUSTER ?|const float2 p = lane == rank ?|'
run_fault F25_loader_transpose depth_completion_tpu_torch/models/weights.py \
  's|^        leaf = "kernel"$|&\n        if kind == "conv":\n            value = value.permute(2, 3, 1, 0)|'
run_fault F26_cli_depth_scale depth_completion_tpu_torch/io/image.py \
  's|(max_distance \* (imgs.astype(dtype)\[..., 0\] / 255.0))|(255.0 / max_distance * imgs.astype(dtype)[..., 0])|'
run_fault F27_png_bgr depth_completion_tpu_torch/io/png.py 's|^    return img$|    return img[..., ::-1]|'
run_fault F28_conv_dx_nomask depth_completion_tpu_torch/ops/conv3x3.py \
  's|out = conv3x3_call(dy, kf, mask=y, emit_masked=need_masked)|out = conv3x3_call(dy, kf, mask=torch.ones_like(y), emit_masked=need_masked)|'
run_fault F29_remat_skips_detached depth_completion_tpu_torch/models/unet.py \
  's|h = run(_up_stage, stage, h, stage_skips, up_target,|h = run(_up_stage, stage, h, [x.detach() for x in stage_skips] if run is not _direct else stage_skips, up_target,|'
run_fault F30_ensemble_lower_median depth_completion_tpu_torch/parallel/ensemble.py \
  's|mid = (s.narrow(dim, (e - 1) // 2, 1) + s.narrow(dim, e // 2, 1)) \* 0.5|mid = s.narrow(dim, (e - 1) // 2, 1)|'
run_fault F31_serve_row_shift depth_completion_tpu_torch/serving/engine.py \
  's|r._result = denses\[i\]|r._result = denses[i - 1]|'
run_fault F32_fast_guidance_graph depth_completion_tpu_torch/pipeline/sampler.py \
  's|with torch.set_grad_enabled(not cfg.detach_unet_grad):|with torch.set_grad_enabled(True):|'
run_fault F33_serve_zero_pad depth_completion_tpu_torch/serving/engine.py \
  's|images = np.concatenate(\[images, images\[:1\].repeat(pad, 0)\])|images = np.concatenate([images, np.zeros_like(images[:1]).repeat(pad, 0)])|'
run_fault F34_idct_round depth_completion_tpu_torch/csrc/jpeg_decode.cpp \
  's|sat16(descale(res\[c\], kConstBits + kPass1Bits + 3))|sat16(res[c] >> (kConstBits + kPass1Bits + 3))|'
run_fault F35_h2v2_replicate depth_completion_tpu_torch/csrc/jpeg_decode.cpp \
  's#} else if (fy == 2 \&\& (fx == 1 || fancy_h)) {#} else if (fy == 2 \&\& fx == 1) {#'
run_fault F36_bl2_unshuffle_ts1 depth_completion_tpu_torch/io/bl2.py \
  's|lib.bl2_unshuffle(block, dst, bsize, typesize)|lib.bl2_unshuffle(block, dst, bsize, 1)|'
run_fault F37_bl2_shape_reversed depth_completion_tpu_torch/io/bl2.py \
  's|\["numpy", \[int(s) for s in x.shape\], x.dtype.str\]|["numpy", [int(s) for s in x.shape[::-1]], x.dtype.str]|'
SAMPLER=depth_completion_tpu_torch/pipeline/sampler.py
run_fault F38_step_not_advanced $SAMPLER \
  '/def replay(self, k: int/,/self.graphs\[name\].replay()/s|self.step_index.fill_(k)|pass|'
run_fault F39_epilogue_row0 depth_completion_tpu_torch/csrc/guidance_epilogue.cu \
  's|const float\* row = table + 6 \* \*step;|const float* row = table;|'
run_fault F40_replay_uncounted $SAMPLER 's|^        add_launches(self.launch_delta\[name\])$|        pass|'
run_fault F41_stale_adam $SAMPLER 's|^        self.m.zero_()$|        pass|; s|^        self.v.zero_()$|        pass|'
UNET=depth_completion_tpu_torch/models/unet.py
run_fault F42_geglu_contiguous depth_completion_tpu_torch/parallel/sharding.py \
  's|halves = sub\[0\] == "proj_in"  # the GEGLU.s value \| gate|halves = False|'
run_fault F43_tp_no_entry $UNET 's|^    return _CopyToModelParallel.apply(x, group)$|    return x|'
run_fault F44_fan_in_bias_each_rank $UNET \
  's|layer({"kernel": p\["kernel"\]}, x), group)|layer(p, x), group)|; s|^    return y + p\["bias"\].to(y.dtype) if "bias" in p else y$|    return y|'
run_fault F45_ensemble_local_rows depth_completion_tpu_torch/parallel/ensemble.py \
  's|rows = torch.arange(r0, r1, device=images.device)|rows = torch.arange(0, r1 - r0, device=images.device)|'
run_fault F46_lcm_stale_renoise $SAMPLER 's|if cfg.seed != self.renoise_seed:|if False:|'
run_fault F47_per_input_adam_row $SAMPLER \
  's|self.opt.step(grads, self.step_index)|self.opt.step(grads, (self.step_index + 1).clamp(max=self.train_steps - 1))|'
run_fault F48_general_no_rescale $SAMPLER \
  's|g = g \* (eps_norm / torch.clamp(g_norm, min=EPSILON)).reshape(n, 1, 1, 1)|g = g|'
run_fault F49_finish_before_last_step $SAMPLER \
  's|^            for k in ks:$|            if graph and name == "step":\n                ks, held = ks[:-1], ks[-1:]\n&|; s|^                (self.replay if graph else self.step_eager)(k, name)$|&\n            if graph and name == "finish":\n                for k in held:\n                    self.replay(k, "step")|'
JPEG_DEC=depth_completion_tpu_torch/csrc/jpeg_decode.cpp
run_fault F50_cmyk_no_k $JPEG_DEC \
  's|k - (((255 - cc) \* k) >> 8)|cc|; s|k - (((255 - mm) \* k) >> 8)|mm|; s|k - (((255 - yy) \* k) >> 8)|yy|'
run_fault F51_bl2_blosclz_codec depth_completion_tpu_torch/io/bl2.py \
  's|WRITE_CODECS = {"blosclz": (0, 0),|WRITE_CODECS = {"blosclz": (1, 0),|'
run_fault F52_smooth_complete $JPEG_DEC \
  's|      if (c.bits\[k\] != 0) useful = true;|      useful = true;|; s|if (bits\[k\] != 0 \&\& ws\[pos\] == 0)|if (ws[pos] == 0)|'
run_fault F53_rle_delta_no_move depth_completion_tpu_torch/io/bmp.py \
  's|                skip = dx + dy \* w|                skip = 0|'
run_fault F54_verify_launch_count scripts/verify_checkpoint_torch.py \
  's|counts = {k: v for counter in COUNTERS|counts = {k: v + (k == "conv3x3") for counter in COUNTERS|'
run_fault F55_frontier_chained_ref scripts/frontier_torch.py \
  's|^            row\["rmse_vs_full_m"\] = float(np.sqrt((diff\*\*2).mean()))$|&\n            ref_out = out|'
run_fault F56_ring_lse_nats $RING \
  's|        ctx.save_for_backward(qs, ks, vs, o, lse2)|        ctx.save_for_backward(qs, ks, vs, o, lse2 * 0.6931471805599453)|'
run_fault F57_kitti_first_as_steady scripts/bench_kitti_torch.py \
  's|^    return min(infer\[1:\]) if len(infer) > 1 else infer\[0\]$|    return infer[0]|'
run_fault F58_scaling_unsynced scripts/drivers_torch.py \
  '/        t0 = time.perf_counter()/,/        times.append/s|^        synchronize(dev)$|        pass|'
run_fault F59_fp32_one_pass depth_completion_tpu_torch/csrc/mma_sync.cuh \
  '/void mma_tf32x3/,/^}/s|if constexpr (kSplit) {|if constexpr (false) {|' \
  $CONV 's|wgmma_tf32(d\[i\], al, bh, t > 0);|wgmma_tf32(d[i], ah, bh, t > 0); continue;|'
run_fault F60_fp32_as_bf16 depth_completion_tpu_torch/ops/flash_attention.py \
  's|^    r = route(_check_cuda_operands(q, k, v, head_dim=d), d)$|    if q.dtype == torch.float32:\n        o, lse2 = flash_fwd(q.bfloat16(), k.bfloat16(), v.bfloat16(), num_heads)\n        return o.float(), lse2\n&|'
GENERIC=depth_completion_tpu_torch/csrc/flash_generic.cuh
run_fault F61_d128_heads_as_d64 $GENERIC \
  's|const T\* qh = q + n \* q_sn + (long)h \* D;|const T* qh = q + n * q_sn + (long)h * (D == 128 ? 64 : D);|'
run_fault F62_fp32_conv_plain depth_completion_tpu_torch/ops/conv3x3.py \
  's|^    if x.device.type == "cpu":$|    if x.device.type == "cpu" or x.dtype == torch.float32:|'
run_fault F63_xch_own_slice $GENERIC \
  's|const float4 x = xb\[(w \* NS + i) \* 32 + lane\];|const float4 x = xb[(ws * NS + i) * 32 + lane];|'
run_fault F64_pv_keys_unpermuted $GENERIC \
  's|const int pos = (r \& ~7) + key_pos(r \& 7);|const int pos = r;|'
run_fault F65_conv_halo_lo_dropped $CONV \
  's|ax\[A32 / 4 + j\] = lo;|ax[A32 / 4 + j] = make_float4(0.f, 0.f, 0.f, 0.f);|'
run_fault F66_conv_tap_shift $CONV \
  's|+ i + t / 3) \* HC32 + t % 3;|+ i + t / 3) * HC32 + (t % 3 == 2 ? 1 : t % 3);|'
run_fault F67_route_skip_library depth_completion_tpu_torch/ops/conv3x3.py \
  's|^    if fits(x.dtype, ci, co):$|    if fits(x.dtype, ci, co) and skip is None:|'
exit $status
