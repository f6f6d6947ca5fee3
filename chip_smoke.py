#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port on one CUDA card.

Run from the root of a checkout, on a machine with a card:

    python3 chip_smoke.py

Phases (each prints its results; any failure exits non-zero before the last
line):
  1. build   -- nvcc every kernel (in parallel), print the card's name and
               power limit, turn TF32 off for the golden path.
  2. kernels -- each of K1-K5 against its plain PyTorch version at the main
               paths' shapes (B=32), f32 and bf16, with times; the golden
               routes of K1-K5 (every product 3xTF32 on wgmma) also against
               a float64 evaluation of the same function (at most 4x the
               plain f32 version's error; K4 with the ResiDual at all six
               main-path layers, K5 also at HTSAT-large's layers, and the
               ResiDual alone at a component count that is no multiple of
               8, golden and AMP), each golden bound at the f32
               CUDA-core rate and for the 3xTF32 arithmetic the route runs,
               K1's golden yardsticks the DFT matmul and the whole function
               as torch.stft -> power -> mel -> dB; K1's routes also at
               ragged clip lengths, B=1 and 3, on silence and with the
               n_fft=1536 frontend, AMP within 0.05 dB; K5 also at
               HTSAT-large's wide layers, at odd window
               counts and at n = 49 tokens; the AMP qkv + attention kernel
               that K2, K4 and K5 share (window_attention_wgmma_kernel)
               timed alone by device time in each of their calls, K2 and
               K4 also at n = 49 and 3 windows; K3's AMP kernel by device
               time (the only kernel of its call, one launch a pass); K2,
               K3 and K4 beside their function as a sequence of PyTorch
               calls (cuBLAS, SDPA); the golden 3xTF32 GEMMs of K2, K3 and
               K5 by device time; K4's device time split by CUDA kernel
               (torch.profiler) at its main-path shapes, AMP and golden;
               the 3xTF32 linear (RoBERTa's golden dense products,
               phase_linear) forward and backward at the contrastive
               cell's M = 96 x 77 = 7392 and RoBERTa-base's three shapes,
               with and without GELU, against its plain version
               (F.linear) and float64 (4x), its launches counted, timed
               beside F.linear; its row of the JSON line is f32.
  2b. gemm   -- the bf16 TMA + wgmma GEMM that K2-K5 run under AMP, alone,
               against its plain version at every GEMM shape of the main
               paths, timed beside its bound and torch.matmul on the same
               bf16 operands (a yardstick the port never calls), by CUDA
               events and by device time. It replaces no TPU kernel by
               itself, so it prints [gemm] lines and has no entry in the
               JSON line.
  3. main    -- ESC-50 zero-shot + ResiDual (layer 0, K=96) through
               HTSAT-tiny at full width, golden f32 and bf16 AMP: the bench
               accuracy guard, the launch counts per forward, clips/s, what
               casting the weights to bf16 costs once, and one
               torch.profiler window over an AMP forward (device time by
               CUDA kernel, the device's idle share, K3's launches, the
               qkv + attention kernel's launches, the ResiDual's two
               gemm_tf32x3_kernel a block and no attention_core_kernel
               under AMP), and one over a golden forward (the same split;
               K1's one logmel_tf32x3_kernel, a gemm_tf32x3_kernel for each
               golden qkv, proj, fc1 and fc2 and each ResiDual product, and
               no other kernel of the port but LayerNorm and the attention
               core).
  3b. main   -- the same program through HTSAT-base, built by name from the
               model registry (ResiDual at layer 0, K=128); layer 3 (C=1024)
               runs K5.
  4. fixture -- the tiny JAX golden fixture (tests/data/torch_port_tiny.npz)
               through the port's kernels.
  4b. fixture -- the wide JAX golden fixture (tests/data/torch_port_wide.npz),
               whose C=1024 layer runs K5.
  5. train   -- ResiDual λ-training on HTSAT-tiny at full width (phase 3's
               seeded model, ResiDual and text embeddings; B=32 clips and
               labels from a seed): train_residual for 2 epochs of 2
               batches, golden f32 (image-cached); one step split into
               forward, backward and Adam by CUDA events, golden and AMP,
               with its peak memory, its launches (the backward launches no
               kernel) and the uncached step beside it; λ's gradient against
               autograd through the plain versions on the card on 5 seeded
               batches, each logged with the spread (golden: max rel err
               <= 1e-3; AMP: cosine >= 0.999); the JAX training
               fixture (tests/data/torch_port_train.npz); the image cache's
               bit-equal resume; evaluate_zero_shot and the K-fold
               artifacts on a held-out batch.
  6. analysis -- the paper's pipeline on HTSAT-tiny at full width (phase 3's
               seeded model, ResiDual and text embeddings; B=32 clips from a
               seed): the residual-tapped forward golden and AMP (every block
               on the split plan: K1, K2 and K3 launched, no K4) against the
               untapped one (golden within atol=2e-3, rtol=1e-3 and cosine >
               0.99999; AMP within the bench guard) and its taps against the
               same forward through the plain versions (golden: atol=2e-3,
               rtol=1e-3, probabilities atol=1e-5; AMP: max rel err 2e-2 and
               cosine > 0.99999), each K2/K5 and K3 call of the tapped
               forward against its plain version on the call's own inputs
               (K3 also without its ResiDual, or with a seeded one and the
               double FFN), with its device-time census by CUDA kernel
               (no device time in three windows fails); the same for the
               attention tap (the model's own attention, K3) and for
               HTSAT-base's residual tap (K5 at layer 3); then
               compute_pca_components at layer 0 on 2 folds -> the
               layer_0_evalfold_{i} pickles ->
               train_and_evaluate_residual (2 epochs), evaluate_baseline_clap,
               train_and_eval_linear_head and compare_variants (the three
               variants' accuracy); run_pca over the attention tap ([60,
               4096, 4096] f32 moments), its randomized finalize against a
               float64 eigh of one head's moments (layers 0 and 3), and the
               CSV; each stage's time by CUDA events beside the bounds, and
               the peak memory. 6b (qr): the blocked float64 Householder QR
               (ops/cuda/qr.py) at each layer's [heads, 4096, 784] (heads 4,
               8, 16, 32): Q against torch.linalg.qr (orthonormal and
               spanning A within 1e-12, each column the library's up to its
               sign within 1e-10), its ms beside its bound (4 D m^2 - 4/3 m^3
               a head at 67 TFLOP/s of float64; A read and Q written once)
               and torch.linalg.qr's (library_ms), 7 calls a layer, which
               make its row of the kernels line; layer 3's device time by
               kernel; one run_pca of the attention tap on B clips: 28
               householder_qr calls (the row's launches), no torch.linalg.qr
               on a card tensor.
  7. clap    -- ESC-50 zero-shot with a real text classifier: CLAPModule
               (HTSAT-tiny + RoBERTa-base at full width, seed 0,
               HashTokenizer), golden and AMP. The text tower at the 50
               prompts and at 32 texts of 77 tokens: golden against a
               float64 copy on the card (atol=2e-3, rtol=1e-3, cosine >
               0.99999), AMP against golden (cosine > 0.999) with its 73
               bf16 GEMM launches; the bf16 GEMM at the text shapes
               against its plain version (phase 2b's loop); evaluate_zeroshot
               on 2 seeded batches of B=32 clips (the audio launches per
               forward, the profiler census of K1, K4, K2 and K3 by kernel,
               the bench guard between the modules, the metrics, clips/s
               with the classifier built once); clap_apply at 32 clips + 32
               texts (its features bit-equal to encode_audio's and
               encode_text's, logit scales 1/0.07, the transform heads
               against float64); the text tower's ms beside its bound, the
               AMP text forward by CUDA kernel, peak memory; the JAX CLAP
               fixture (tests/data/torch_port_clap.npz) for the roberta,
               bert, bart and transformer towers ([fixture-clap] lines).
  8. contrastive -- CLAP training on CLAPModule()'s model (HTSAT-tiny +
               RoBERTa-base at full width, seed 0, HashTokenizer, 77-token
               context), B=32 ESC-50-length clips (repeat-padded) and 32
               texts from a seed, golden f32 and bf16 AMP: every
               parameter's gradient of one step against the same step on
               the plain route on the card (golden: max rel err <= 1e-3 a
               tower; AMP: cosine >= 0.999 a tower, or >= the plain
               route's own cosine against the golden step where bf16 moves
               it further, as it does RoBERTa's at random weights; the
               worst parameter named); the launch census of one training
               forward against the JAX package's dispatch
               (tests/torch_port_fixture.py::expected_launches: K1 1, K4 1,
               K2 11; AMP also RoBERTa's 73 bf16 GEMMs; no other kernel); the loop main runs per epoch
               (training/main.py::train_one_epoch) for 4 AdamW steps under
               the cosine schedule with the epoch's generator (SpecAugment,
               drop-path, dropout), counts set to 0 before it and read
               after; every step's loss finite, the fixed batch's loss
               without randomness lower after the loop than before, the
               logit scale <= ln(100), bn0's running buffers moved, the
               launches 4x the census; every K4 and K2 call
               of a forward at the updated weights against its plain
               version on its own inputs, and the derived-weight caches not
               growing; step ms by CUDA events split into forward, backward
               and optimizer, peak memory, one profiler window (idle share);
               a checkpoint save -> resume that reproduces the next step bit
               for bit (golden, deterministic algorithms on).
  9. towers  -- every other audio tower the JAX package builds, fusion and
               the file and fold entry points, at full width, B = 32, seed 0.
               9a: create_model("PANN-14", "roberta"): K1 + Cnn14 on ESC-50
               length clips (240 000 samples repeat-padded to 480 000),
               golden and AMP (a PANN tower runs f32 in both), one launch
               of K1 a forward and no K2-K5, the embedding against the
               plain route on the card (atol 2e-3, rtol 1e-3, cosine >
               0.99999) and the guard against 50 text embeddings; host ms
               and clips/s (median of 5), CUDA-event ms, one profiler
               window (busy / idle, device ms by kernel, cuDNN's convs by
               name), peak memory; one forward of Cnn6 and Cnn10, and of
               PANN-14-fmax-8k-20s at 960 000 samples (K1 at hop 360
               against its plain version). 9b: CLAPModule(enable_fusion=True)
               (HTSAT-tiny aff_2d + RoBERTa-base): 16 clips of 20 s and 16
               of 5 s through get_audio_embedding_from_data, golden and
               AMP: the fusion mel (get_mel, the HTK filterbank) on K1
               against its plain version and float64, the census (K1 32,
               one a clip; K4 10, K2 2, K3 2), the forward against the
               plain route, the guard (AMP against golden: cosine > 0.999,
               argmax agreement 1.0 over the 50 prompts), featurization ms
               apart from forward ms. 9c: seeded PCM16 WAVs (44.1 kHz
               stereo, 3-25 s) through get_audio_embedding_from_filelist on
               both modules; the C decoder (native/wavio.c) bit-equal to
               numpy; eval_zeroshot_classification.main and lp_main.main
               on an ESC-50-shaped tree (2 folds x 8 clips, esc50.csv);
               the PANN and fusion JAX fixtures ([fixture-towers] lines).
  10. shards and vision -- 10a (``[shards]``): seeded PCM16 WAV tar shards
               (7-13 s mono at 48 kHz, caption JSON, sizes.json, a train
               split of 2 x 9 clips with one truncated member and a valid
               split of 8) through training/main.py's main, once with the
               default --dataset-type and once with webdataset:
               create_model("HTSAT-tiny", "roberta") at full width,
               HashTokenizer, golden, B=8, 2 epochs of 2 steps, validation
               before and after each epoch; every loss finite, each step's
               launches the training census of phase 8 (K1 1, K4 1, K2 11),
               the run's the steps' plus 3 validation forwards', the
               checkpoint written; ms a step and the host's share between
               steps (decode + featurization); eval_retrieval_main on the
               valid split with that checkpoint (metrics in [0, 1]);
               check_tars names the truncated shard; AudioProcessing.
               mel_spectrogram of 8 seeded 5 s clips at 44.1 kHz (levels
               1e-4..1, so the 80 dB floor below the batch's max bites) on
               K1, one launch, against its plain version (phase 2's limit)
               and float64 with the floor applied. 10b (``[vision]``): each
               of the 10 vision configs through create_model(name,
               "transformer", seed=0) on the card, a B=2 image + text
               forward (finite, unit norms, logit scale 1/0.07, peak
               memory); RN50 and ViT-B-32 at B=32 and 224^2 golden by CUDA
               events, images/s, against the same model on the CPU (max rel
               err <= 1e-4); zero_shot_eval of ViT-B-32 on 64 seeded images
               over the 1000 ImageNet classes with the first 2 of the 80
               templates (time); the vision JAX fixture ([fixture-vision]
               lines). No kernel is on the vision path.
  11. fsdp   -- FSDP on the card: torch's version and fully_shard's keywords;
               phase 8's model (CLAPModule(): HTSAT-tiny + RoBERTa-base) and
               batch, 2 AdamW steps from one state with the same draws,
               without FSDP and through make_train_step(fsdp_mesh=...) over
               a one-rank NCCL group (parallel/fsdp.py), without and with
               remat, golden and AMP: each step's launches phase 8's census
               (twice it under remat); the losses and every
               parameter against the step without FSDP (golden: losses rtol
               1e-5, parameters atol 2e-5, rtol 1e-4; AMP: losses within 2e-2,
               each tower's update cosine >= 0.999); each run's own peak
               memory, and its step ms over 10 rounds of one step of each
               run in turn (each FSDP run's differences from the step
               without FSDP in full); check_ckpt_diff between checkpoints
               before and after a --freeze-text step (every parameter its
               gradient reached moved, every text parameter not);
               measure_seconds against time_ms on one forward (5 trials,
               medians within 1.1x; each trial's reps, the garbage
               collector's passes and the card's clock beside, and the
               device time of a forward); dryrun_multichip over every
               card, stages 1, 2 and 2b, one process a card (their
               records as printed).
  12. experiments -- the paper's experiment drivers
               (audio_residual_tpu_torch/examples/), golden f32. 12a:
               full_workflow.main(["--size", "full"]) at its defaults
               (HTSAT-tiny + RoBERTa-base, 5 classes, 2 folds, 32 clips a
               split of 240 000 samples repeat-padded to 480 000, 16
               epochs, ResiDual at layer 3, anchored text): each stage's
               seconds, wrapper launches and port kernels in a
               torch.profiler window (CUDA activity); every learning check
               printed; asserted: λ moved, the loss finite, the two npz and
               two pkl, K1-K4 launched and K5 not (counts set to 0 before
               main, read after). 12b: the baseline eval of fold 0 and one
               λ epoch (one Adam step) through the kernels and under
               plain_kernels(), the same weights: predictions equal,
               similarities, λ and the loss of fold 0's first batch within
               atol 2e-3, rtol 1e-3, and λ's gradient on that batch within
               GRAD_REL (max relative error; λ after one Adam step sees
               only the gradient's signs). 12c: drivers
               1-3 through CLAPModule() (seed 0) on a seeded ESC-50 tree
               (esc50.csv and the audio directory, 5 folds, 50 classes x 2
               clips of 5 s at 48 kHz): analyze_clap_attention
               --max-batches 2, apply_residual_to_clap --layers 0 --epochs
               2, evaluate_and_compare --epochs 2; each one's files (the
               CSV, 5 PCA pickles, 15 npz, ESC50_table.json). 12d:
               perf_breakdown.main at B = 32 (AMP), its PERF_BREAKDOWN line
               beside the card's name and power limit.
Then one JSON line of per-kernel numbers (bf16, summed over one forward of
each main path: ``launches`` is the sum of the two paths' counts), the card
line, and the final ``{"ok": true, "device": ...}`` line. Imports nothing of
JAX.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

try:  # the card's timing helpers; outside a checkout main() stops before any use
    from audio_residual_tpu_torch.utils.profiling import (device_busy_ms, device_profile,
                                                          profile_until, time_ms)
except ModuleNotFoundError as e:
    if e.name != "audio_residual_tpu_torch":  # a fault inside the package: say so
        raise

REPO = os.path.dirname(os.path.abspath(__file__))
B = 32
CLIP = 240000  # ESC-50: 5 s at 48 kHz
N_CLASSES = 50
EXPECTED_LAUNCHES = {"fused_logmel": 1, "fused_swin_block": 10, "fused_window_attention": 2,
                     "fused_residual_ffn": 2}
EXPECTED_BASE_LAUNCHES = {"fused_logmel": 1, "fused_swin_block": 16, "wide_window_attention": 2,
                          "fused_residual_ffn": 2}
TOL = {"f32": 1e-4, "bf16": 2e-2}  # max |kernel - plain| / max |plain|
# the training phase: epochs of batches of B clips, Adam's rate, timed steps;
# a step's forward from the cached image launches K4 at layers 0-2 and the
# split plan at layer 3, the backward none
TRAIN_EPOCHS, TRAIN_BATCHES, TRAIN_LR, TRAIN_TIMED_STEPS = 2, 2, 0.01, 5
TRAIN_LAUNCHES = {"fused_swin_block": 10, "fused_window_attention": 2, "fused_residual_ffn": 2}
GRAD_REL = 1e-3   # golden λ-gradient: max |card - plain| / max |plain|
GRAD_COS = 0.999  # AMP λ-gradient: cosine against the plain versions'
# the training fixture's bounds (tests/test_torch_train_residual.py)
TRAIN_FIXTURE_TOL = {"loss": dict(rtol=1e-4, atol=0), "step_loss": dict(rtol=1e-4, atol=0),
                     "lam": dict(rtol=0, atol=1e-4), "sims": dict(rtol=0, atol=2e-3)}
K1_AMP_DB = 0.05  # K1 bf16 against its plain version, dB: the JAX kernel's AMP error
HBM_BYTES_S = 3.35e12  # H100 SXM peaks: HBM3 bandwidth, dense f32 / TF32 / bf16 rates
PEAK = {"f32": 67e12, "tf32": 495e12, "bf16": 989e12, "f64": 67e12}
# golden routes against float64: at most this times the plain f32 version's error
GOLDEN_F64_RATIO = 4.0
# a golden forward's 3xTF32 GEMMs: fc1 and fc2 of each FFN pass (layer 0's
# blocks run two passes: ResiDual's double FFN), qkv and proj of each K2, K4
# and K5 call, and the ResiDual's two products in each of layer 0's blocks
EXPECTED_GOLDEN_TF32X3 = {"tiny": 2 * (2 * 2 + 2 + 6 + 2) + 2 * (10 + 2) + 2 * 2,
                          "base": 2 * (2 * 2 + 2 + 12 + 2) + 2 * (16 + 2) + 2 * 2}
RESIDUAL_BLOCKS = 2  # the main paths' ResiDual: both blocks of layer 0
GRAD_BATCHES = 5  # seeded batches of the λ-gradient checks
# the analysis phase: seeded batches of B clips (fold i trains on all but
# batch i and is evaluated on it), the attention PCA's batches, the folds'
# λ-training epochs; the tapped forwards' launches (every block on the split
# plan: HTSAT-tiny 12 blocks, HTSAT-base 18, whose layer 3 runs K5)
ANALYSIS_BATCHES, ATTENTION_PCA_BATCHES, ANALYSIS_EPOCHS = 3, 3, 2
TAPPED_LAUNCHES = {"fused_logmel": 1, "fused_window_attention": 12, "fused_residual_ffn": 12}
ATTENTION_TAP_LAUNCHES = {"fused_logmel": 1, "fused_residual_ffn": 12}
BASE_TAPPED_LAUNCHES = {"fused_logmel": 1, "fused_window_attention": 16,
                        "wide_window_attention": 2, "fused_residual_ffn": 18}
PCA_F64_CHECK = dict(top=32, rtol=1e-3, span=0.99)  # tests/test_pca.py:181-192
# the PCA finalize's QRs: [heads, D = 8^4, m = 768 + 16] at each of the 4
# layers (the widest, layer 3's, checked and profiled); one run_pca
# orthonormalises iters + 1 = 7 blocks a layer
QR_HEADS, QR_SHAPE, QR_PER_LAYER = (4, 8, 16, 32), (32, 4096, 784), 7
RUN_PCA_QR_CALLS = QR_PER_LAYER * len(QR_HEADS)
# the CLAP phase: RoBERTa's context, the zero-shot batches of B clips; the
# AMP text forward's bf16 GEMMs (q, k, v, out, fc1, fc2 a layer, the pooler);
# the port's kernels of one audio forward without a ResiDual by profiler
# name (golden: K4's LN1 and LN2 and K3's add+LN2, a core and the qkv and
# proj products a K2/K4 call, fc1 and fc2 a FFN pass; AMP: K4's two LNs,
# its proj, fc1 and fc2 and K2's proj on the bf16 GEMM, one clustered launch
# a K3 call)
TEXT_CONTEXT, CLAP_BATCHES = 77, 2
TEXT_GEMMS = 6 * 12 + 1
# golden: q, k and v one product a layer (models/roberta.py::_qkv)
TEXT_LINEARS = 4 * 12 + 1


def text_launches(md, *, train_step: bool = False, remat: bool = False) -> dict:
    """RoBERTa-base's launches in one forward of weights that require grad:
    under AMP the bf16 GEMM a dense product (its backward launches nothing);
    golden the 3xTF32 linear a product (q, k and v one), each with a split
    of its weight, and with ``train_step`` the backward's dx and dW products
    and the split of dW's operand (``remat``: the forward twice)."""
    if md is not None:
        return {"gemm": TEXT_GEMMS * (2 if remat else 1)}
    if not train_step:
        return {"linear_tf32x3": TEXT_LINEARS, "split_tf32": TEXT_LINEARS}
    forwards = 2 if remat else 1
    return {"linear_tf32x3": forwards * TEXT_LINEARS,
            "split_tf32": (forwards + 1) * TEXT_LINEARS,
            "linear_tf32x3.dx": TEXT_LINEARS, "linear_tf32x3.dw": TEXT_LINEARS}


def golden_text_census_ok(census: dict) -> bool:
    """One golden text forward without a graph: the 3xTF32 linear a product
    (q, k and v one), a split of each concatenated q, k, v weight and of
    each other weight that requires grad (a frozen one's is kept for its
    version), nothing else."""
    return (census.get("linear_tf32x3") == TEXT_LINEARS
            and 12 <= census.get("split_tf32", 0) <= TEXT_LINEARS
            and set(census) <= {"linear_tf32x3", "split_tf32"})
CLAP_CENSUS = {
    "f32": {"logmel_tf32x3_kernel": 1, "add_layernorm_kernel": 2 * 10 + 2,
            "attention_core_kernel": 12, "gemm_tf32x3_kernel": 2 * 12 + 2 * 12},
    "bf16": {"logmel_wgmma_kernel": 1, "add_layernorm_kernel": 2 * 10,
             "window_attention_wgmma_kernel": 12, "gemm_kernel": 3 * 10 + 2,
             "ffn_cluster_kernel": 2},
}
GOLDEN_TEXT = dict(atol=2e-3, rtol=1e-3, cos=0.99999)  # PERF.md §2's golden parity
TAP_AMP_COS = 0.99999  # AMP taps against the plain route: cosine, beside TOL["bf16"]
# the kernels of the port by role (profiler names); any other kernel of the
# port (namespace arpu) counts under its own name
PORT_KERNELS = ("gemm_tf32x3_kernel", "gemm_kernel", "attention_core_kernel",
                "add_layernorm_kernel", "window_attention_wgmma_kernel", "ffn_cluster_kernel",
                "logmel_tf32x3_kernel", "logmel_wgmma_kernel", "householder_panel_kernel")
GOLDEN_KERNELS = {"logmel_tf32x3_kernel", "gemm_tf32x3_kernel", "attention_core_kernel",
                  "add_layernorm_kernel"}


def log(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


class KernelStats:
    """Phase 2's per-kernel numbers. The JSON line holds the bench's AMP mode
    (bf16), summed over the launches of one forward of each main path, the
    QR's one mode (float64), summed over the 28 calls of one ``run_pca`` of
    the attention tap (phase 6b), and the 3xTF32 linear's one mode (f32),
    summed over phase 2's six forward + backward passes (``phase_linear``)."""

    JSON_MODES = ("bf16", "f64")
    # a kernel with a golden route alone: its row is that mode
    ONLY_MODE = {"linear_tf32x3": "f32"}

    def __init__(self, kernels: dict):
        self.kernels = kernels
        self.rows = {name: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                                bytes_ms=0.0, ops_ms=0.0, library_ms=None) for name in kernels}
        # the golden f32 rows, summed the same way (the training path's mode)
        self.golden = {name: collections.Counter() for name in kernels}

    def in_row(self, name, mode) -> bool:
        return mode in self.JSON_MODES or self.ONLY_MODE.get(name) == mode

    def check(self, name, label, got, ref, mode) -> None:
        import torch

        torch.cuda.synchronize()
        err = float((got.float() - ref.float()).abs().max())
        rel = err / float(ref.float().abs().max())
        finite = bool(torch.isfinite(got.float()).all())
        ok = finite and rel < TOL[mode] and got.dtype == ref.dtype and got.shape == ref.shape
        log("kernels", check=f"{name} {label}", mode=mode, max_abs_err=err, max_rel_err=rel,
            tol=TOL[mode], ok=ok)
        if not ok:
            raise AssertionError(f"{name} {label} ({mode}) disagrees with its plain version")
        if self.in_row(name, mode):
            self.rows[name]["max_abs_err"] = max(self.rows[name]["max_abs_err"], err)

    def time(self, name, label, mode, kernel_fn, plain_fn, nbytes, flops, launches=1,
             library_fn=None, library_what=None, route_flops=None) -> None:
        """``nbytes``: each input read once, each output written once;
        ``flops``: {peak type: operations} of one launch; ``library_what``
        says what ``library_fn`` computes when it is not the same function.
        ``route_flops``: the operations the route itself runs, by type (a
        3xTF32 route: three TF32 products for each f32 one), for a second
        bound, ``route_bound_ms``, beside the f32 one."""
        ms = launches * time_ms(kernel_fn)
        plain = launches * time_ms(plain_fn)
        lib = launches * time_ms(library_fn) if library_fn is not None else None
        b_ms = launches * 1e3 * nbytes / HBM_BYTES_S
        o_ms = launches * 1e3 * sum(f / PEAK[t] for t, f in flops.items())
        extra = {"library": repr(library_what)} if library_what else {}
        route_ms = None
        if route_flops is not None:
            route_ms = max(b_ms, launches * 1e3 * sum(f / PEAK[t] for t, f in route_flops.items()))
            extra["route_bound_ms"] = route_ms
        log("kernels", kernel=name, shape=label, mode=mode, launches=launches, ms=ms,
            plain_ms=plain, bound_ms=max(b_ms, o_ms),
            bound_by="bytes" if b_ms >= o_ms else "operations", library_ms=lib, **extra)
        if mode == "f32":
            g = self.golden[name]
            g.update(ms=ms, plain_ms=plain, bound_ms=max(b_ms, o_ms),
                     route_bound_ms=route_ms if route_ms is not None else max(b_ms, o_ms))
            if lib is not None:
                g["library_ms"] += lib
        if self.in_row(name, mode):
            r = self.rows[name]
            r["ms"] += ms
            r["plain_ms"] += plain
            r["bound_ms"] += max(b_ms, o_ms)
            r["bytes_ms"] += b_ms
            r["ops_ms"] += o_ms
            if lib is not None:
                r["library_ms"] = (r["library_ms"] or 0.0) + lib

    def log_golden(self) -> None:
        """One line a kernel: its golden f32 rows summed over the main paths'
        launches, with the yardstick as PyTorch calls in f32 (TF32 off);
        ``bound_ms`` at the f32 CUDA-core rate, ``route_bound_ms`` for the
        arithmetic the route runs (3xTF32 where it does)."""
        for name, g in self.golden.items():
            if not g:  # no f32 route: the QR runs float64 alone
                continue
            extra = {k: g[k] for k in ("stft_chain_ms",) if k in g}
            log("kernels", golden_summary=name, mode="f32", ms=g["ms"], plain_ms=g["plain_ms"],
                bound_ms=g["bound_ms"], route_bound_ms=g["route_bound_ms"],
                library_ms=g["library_ms"] or None, **extra)

    def check_f64(self, name, label, got, plain, ref64) -> None:
        """A golden route against float64: its error at most
        ``GOLDEN_F64_RATIO`` times the plain f32 version's."""
        from tests.torch_f64_reference import error_ratio

        err, plain_err, ratio = error_ratio(got, plain, ref64)
        ok = ratio <= GOLDEN_F64_RATIO
        log("kernels", check=f"{name} {label} against float64", mode="f32",
            max_abs_err_f64=err, plain_max_abs_err_f64=plain_err, ratio=ratio,
            limit=GOLDEN_F64_RATIO, ok=ok)
        if not ok:
            raise AssertionError(f"{name} {label}: {ratio:.2f}x the plain version's error "
                                 "against float64")

    def json_line(self, launches: dict) -> str:
        out = []
        for name, (src, replaces) in self.kernels.items():
            r = self.rows[name]
            out.append({
                "name": name, "route": "cuda",
                "source": f"audio_residual_tpu_torch/ops/cuda/csrc/{src}.cu",
                "replaces": replaces, "launches": launches.get(name, 0),
                "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"],
                "bound_by": "bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations",
                "library_ms": r["library_ms"],
            })
        return json.dumps({"kernels": out})


def audio_frontend(name: str):
    """The frontend of a registered HTSAT model config."""
    from audio_residual_tpu_torch.models.factory import get_model_config
    from audio_residual_tpu_torch.ops.frontend import FrontendConfig

    a = get_model_config(name)["audio_cfg"]
    return FrontendConfig(sample_rate=a["sample_rate"], n_fft=a["window_size"],
                          hop_length=a["hop_size"], win_length=a["window_size"],
                          n_mels=a["mel_bins"], fmin=a["fmin"], fmax=a["fmax"])


def check_logmel(stats: KernelStats, label: str, wav, cfg, mode: str,
                 silence: bool = False) -> None:
    """K1 against its plain version: ``TOL`` and, under AMP, at most
    ``K1_AMP_DB`` dB apart; on silence both give the amin floor exactly
    (the golden route: both give the same bits)."""
    import torch

    from audio_residual_tpu_torch.ops.cuda import frontend as k1

    got, ref = k1.fused_logmel(wav, cfg, mode), k1.logmel_plain(wav, cfg, mode)
    stats.check("fused_logmel", label, got, ref, mode)
    if mode != "bf16":
        if silence and not torch.equal(got, ref):
            raise AssertionError(f"fused_logmel {label}: golden differs from plain on silence")
        return
    err = float((got - ref).abs().max())
    extra = {}
    if silence:
        floor = 10.0 * torch.log10(torch.tensor(cfg.amin, device=got.device)) - k1._db_offset(cfg)
        extra["amin_floor_exact"] = bool((got == floor).all()) and bool((ref == floor).all())
    ok = err <= K1_AMP_DB and extra.get("amin_floor_exact", True)
    log("kernels", check=f"fused_logmel {label} dB", max_abs_err_db=err, limit_db=K1_AMP_DB,
        n_fft=cfg.n_fft, **extra, ok=ok)
    if not ok:
        raise AssertionError(f"fused_logmel {label}: {err} dB from its plain version")


def phase_kernels(stats: KernelStats, dev) -> None:
    import torch
    import torch.nn.functional as F

    from audio_residual_tpu_torch.ops import frontend as fe
    from audio_residual_tpu_torch.ops.common import layer_norm
    from audio_residual_tpu_torch.ops.cuda import frontend as k1
    from audio_residual_tpu_torch.ops.cuda import ln_mlp as k3
    from audio_residual_tpu_torch.ops.cuda import swin_block as k4
    from audio_residual_tpu_torch.ops.cuda import wide_attention as k5
    from audio_residual_tpu_torch.ops.cuda import window_attention as k2
    from audio_residual_tpu_torch.ops.frontend import FrontendConfig, mel_active_bins
    from tests import torch_f64_reference as f64

    rng = np.random.default_rng(0)
    modes = (("f32", None), ("bf16", torch.bfloat16))

    def t(*shape, scale=1.0, offset=0.0):
        a = (offset + scale * rng.standard_normal(shape)).astype(np.float32)
        return torch.from_numpy(a).to(dev)

    def nbytes_of(tensors):
        return sum(x.numel() * x.element_size() for x in tensors)

    def typed(mode, flops_by_type):
        """The golden mode runs every product in f32."""
        return {"f32": sum(flops_by_type.values())} if mode == "f32" else flops_by_type

    # K1 at [32, 480000], one launch a forward of each main path: "f32" runs
    # logmel_tf32x3_kernel (3xTF32), "bf16" (AMP) logmel_wgmma_kernel
    cfg = FrontendConfig()
    wav = t(B, 480000, scale=0.1)
    lo, hi = mel_active_bins(cfg)
    nb, nf = hi - lo, cfg.num_frames(480000)
    basis = torch.from_numpy(k1._constants(cfg)[0]).to(dev)
    for mode, md in modes:
        check_logmel(stats, "[32,480000]", wav, cfg, mode)
        nbytes = 4 * (wav.numel() + cfg.n_fft * 2 * nb + nb * cfg.n_mels + B * nf * cfg.n_mels)
        dft, fold = 2.0 * B * nf * cfg.n_fft * 2 * nb, 2.0 * B * nf * nb * cfg.n_mels
        flops = {"bf16": dft, "f32": fold}
        # yardstick, not the same function: the DFT product alone, one
        # torch.matmul of pre-materialised frames [B*nf, n_fft] by the basis
        # [n_fft, 2*nbins], both in the mode's operand type
        frames = (fe.reflect_pad(wav, cfg.n_fft // 2).unfold(-1, cfg.n_fft, cfg.hop_length)
                  .reshape(-1, cfg.n_fft).to(md or torch.float32).contiguous())
        bm = basis.to(md or torch.float32)
        stats.time("fused_logmel", "[32,480000]", mode, lambda: k1.fused_logmel(wav, cfg, mode),
                   lambda: k1.logmel_plain(wav, cfg, mode), nbytes, typed(mode, flops),
                   launches=2, library_fn=lambda: torch.matmul(frames, bm),
                   library_what="torch.matmul frames @ basis: the DFT product alone",
                   route_flops={"tf32": 3 * dft, "f32": fold} if md is None else None)
        if md is None:
            # the whole function as library calls (cuFFT's STFT in f32), a
            # second yardstick the port never calls; and the error against
            # float64 beside the plain version's
            chain = stft_chain(cfg, dev)
            log("kernels", kernel="fused_logmel", shape="[32,480000]", mode=mode,
                stft_chain_ms=2 * time_ms(lambda: chain(wav)),
                stft_chain_device_ms=device_busy_ms(lambda: chain(wav)),
                stft_chain_rel_err=rel_err(chain(wav), k1.logmel_plain(wav, cfg)),
                library=repr(STFT_CHAIN))
            stats.golden["fused_logmel"]["stft_chain_ms"] += 2 * time_ms(lambda: chain(wav))
            stats.check_f64("fused_logmel", "[32,480000]", k1.fused_logmel(wav, cfg),
                            k1.logmel_plain(wav, cfg), f64.logmel64(wav, cfg))
        # device time of one call: the log-mel kernel alone, and all of the
        # call's kernels (the wrapper's cast and reflect pad too)
        k1.fused_logmel(wav, cfg, mode)
        prof = device_profile(lambda: [k1.fused_logmel(wav, cfg, mode) for _ in range(5)])
        log("kernels", kernel="fused_logmel", shape="[32,480000]", mode=mode,
            kernel_device_ms=sum(v for n, v in prof[1].items() if "logmel" in n) / 5
            if prof else None, call_device_ms=prof[2] / 5 if prof else None,
            dft_matmul_device_ms=device_busy_ms(lambda: torch.matmul(frames, bm)))
        del frames
    # K1's AMP route at ragged shapes (nf = 209 at 100 000 samples is no
    # multiple of its 128-frame tile), silence and the n_fft=1536 frontend;
    # clips from their own generator, so the other kernels' inputs stay
    clips = np.random.default_rng(5)

    def clip_of(b, n):
        return torch.from_numpy((0.1 * clips.standard_normal((b, n))).astype(np.float32)).to(dev)

    win1536 = audio_frontend("HTSAT-tiny-win-1536")
    for mode in ("bf16", "f32"):
        for b in (1, 3):
            for n in (48000, 100000, 240000, 480000):
                check_logmel(stats, f"[{b},{n}]", clip_of(b, n), cfg, mode)
        check_logmel(stats, "[3,48000] silence", torch.zeros(3, 48000, device=dev), cfg, mode,
                     silence=True)
        for b, n in ((1, 100000), (3, 240000)):
            check_logmel(stats, f"[{b},{n}] n_fft=1536", clip_of(b, n), win1536, mode)
    wav1536 = clip_of(B, 480000)
    stats.check_f64("fused_logmel", "[32,480000] n_fft=1536", k1.fused_logmel(wav1536, win1536),
                    k1.logmel_plain(wav1536, win1536), f64.logmel64(wav1536, win1536))
    del wav1536

    def block(c, nh):
        hidden = 4 * c
        flat = (t(c, scale=0.1, offset=1.0), t(c, scale=0.1), t(3 * c, c, scale=0.02),
                t(3 * c, scale=0.02), t(c, c, scale=0.02), t(c, scale=0.02),
                t(c, scale=0.1, offset=1.0), t(c, scale=0.1), t(hidden, c, scale=0.02),
                t(hidden, scale=0.02), t(c, hidden, scale=0.02), t(c, scale=0.02),
                t(225, nh, scale=0.02))
        q, _ = np.linalg.qr(rng.standard_normal((c, c)))
        res = (torch.from_numpy(q.astype(np.float32)).to(dev), t(c, scale=0.01),
               t(c, scale=0.1, offset=1.0))
        return flat, res

    k4_main = []  # the main paths' AMP K4 calls, with their launches a forward
    k4_golden = []  # and their golden calls
    # K4 at layers 0-2 of HTSAT-tiny, then HTSAT-base: (C, heads, windows per
    # clip, grid, main-path launches per shift, main path has ResiDual +
    # double-FFN: layer 0); shift 0 and 4; ResiDual off / on / on + double-FFN
    for c, nh, nw, hw, per_shift, path_res in ((96, 4, 64, (64, 64), 1, True),
                                                (192, 8, 16, (32, 32), 1, False),
                                                (384, 16, 4, (16, 16), 3, False),
                                                (128, 4, 64, (64, 64), 1, True),
                                                (256, 8, 16, (32, 32), 1, False),
                                                (512, 16, 4, (16, 16), 6, False)):
        flat, res = block(c, nh)
        hidden, r = 4 * c, B * nw * 64
        x32 = t(B * nw, 64, c, scale=0.5)
        for mode, md in modes:
            # AMP: layer 0 carries bf16 activations, layers 1-2 f32 (PatchMerging's)
            x = x32.to(md) if (md is not None and path_res) else x32
            for shift in (0, 4):
                for use_res, dffn in ((False, False), (True, False), (True, True)):
                    args = (x, flat + (res if use_res else ()), nh, 8, nw, shift, hw, use_res,
                            dffn, md)
                    label = f"C={c} shift={shift} res={use_res} dffn={dffn}"
                    stats.check("fused_swin_block", label, k4.fused_swin_block(*args),
                                k4.swin_block_plain(*args), mode)
                    on_path = (use_res, dffn) == ((True, True) if path_res else (False, False))
                    if md is None and not on_path and dffn and shift == 4:
                        # every product on the 3xTF32 GEMM, the ResiDual's too, at every
                        # main-path layer
                        rp = dict(zip(("basis", "mean", "lam"), res))
                        stats.check_f64("fused_swin_block", label, k4.fused_swin_block(*args),
                                        k4.swin_block_plain(*args),
                                        f64.block64(x, flat, rp, nh, 8, shift, hw, dffn))
                    if not on_path:
                        continue
                    (k4_golden if md is None else k4_main).append(
                        (lambda a=args: k4.fused_swin_block(*a), per_shift))
                    passes = 2 if dffn else 1
                    ffn = passes * 4.0 * r * c * hidden
                    gemms, core = 8.0 * r * c * c, 4.0 * r * 64 * c
                    flops = {"bf16": gemms + core + ffn}
                    if use_res:
                        flops["f32"] = 4.0 * r * c * c
                    seq = block_sequence(args, md or torch.float32)
                    # golden: every product in 3xTF32 (the ResiDual's too), the
                    # attention core on the CUDA cores
                    route = {"tf32": 3 * (ffn + gemms + flops.get("f32", 0.0)), "f32": core}
                    stats.time("fused_swin_block", label, mode,
                               lambda: k4.fused_swin_block(*args),
                               lambda: k4.swin_block_plain(*args),
                               2 * nbytes_of([x]) + nbytes_of(args[1]), typed(mode, flops),
                               launches=per_shift, library_fn=seq, library_what=BLOCK_SEQUENCE,
                               route_flops=route if md is None else None)
                    if md is None:
                        rp = dict(zip(("basis", "mean", "lam"), res)) if use_res else None
                        stats.check_f64("fused_swin_block", label, k4.fused_swin_block(*args),
                                        k4.swin_block_plain(*args),
                                        f64.block64(x, flat, rp, nh, 8, shift, hw, dffn))
                    log("kernels", kernel="fused_swin_block", shape=label, mode=mode,
                        yardstick_rel_err=rel_err(seq(), k4.swin_block_plain(*args)))
                    if md is not None:
                        attention_launch("fused_swin_block", label, mode,
                                         lambda: k4.fused_swin_block(*args), r, c)

    # K4's device time by CUDA kernel, summed over one forward of each main path
    def k4_forwards():
        for fn, launches in k4_main:
            for _ in range(launches):
                fn()

    def k4_golden_forwards():
        for fn, launches in k4_golden:
            for _ in range(launches):
                fn()

    k4_main[0][0]()  # warm
    log_profile("kernels", "K4 bf16, one forward of each main path", device_profile(k4_forwards))
    k4_golden[0][0]()
    log_profile("kernels", "K4 f32, one forward of each main path",
                device_profile(k4_golden_forwards))

    def k3_device_time(label, fargs, md, mode, seq, ops) -> None:
        """K3's device time of one call: under AMP the clustered kernel alone
        (it must be the call's only kernel: one launch a pass), golden its
        two 3xTF32 GEMMs (fc1, fc2; with add+LN2 the call's only kernels),
        and the call; the yardstick sequence beside it."""
        call = lambda: k3.fused_residual_ffn(*fargs, mxu_dtype=md)  # noqa: E731
        # AMP: one ffn_cluster_kernel a call; golden: add+LN2 and two GEMMs
        want = 5 if md is not None else 15
        call()
        for _ in range(3):  # a window now and then drops kernel records
            prof = device_profile(lambda: [call() for _ in range(5)])
            if prof is None or sum(prof[4].values()) == want:
                break
        extra = {}
        if prof is not None and md is not None:
            kernels = prof[4]
            if set(kernels) != {n for n in kernels if "ffn_cluster_kernel" in n} or \
                    sum(kernels.values()) != 5:
                raise AssertionError(f"fused_residual_ffn {label}: AMP calls launched "
                                     f"{dict(kernels)}, expected one ffn_cluster_kernel each")
            k_ms = sum(prof[1].values()) / 5
            extra = dict(kernel_device_ms=k_ms, kernel_tflops=ops / k_ms / 1e9,
                         kernel_peak_share=ops * 1e3 / k_ms / PEAK[mode],
                         kernel_names=json.dumps(sorted(kernels)))
        elif prof is not None:
            kernels = prof[4]
            ours = port_kernels(kernels)
            if set(ours) - {"gemm_tf32x3_kernel", "add_layernorm_kernel"} or \
                    (sum(kernels.values()) == want and ours["gemm_tf32x3_kernel"] != 10):
                raise AssertionError(f"fused_residual_ffn {label}: golden calls launched "
                                     f"{dict(kernels)}, expected fc1 and fc2 on gemm_tf32x3")
            k_ms = sum(v for n, v in prof[1].items() if "gemm_tf32x3_kernel" in n) / 5
            extra = dict(tf32x3_gemms_device_ms=k_ms, tf32x3_gemms_tflops=ops / k_ms / 1e9,
                         tf32x3_peak_share=3 * ops * 1e3 / k_ms / PEAK["tf32"],
                         kernel_names=json.dumps(sorted(kernels)))
        log("kernels", kernel="fused_residual_ffn", shape=label, mode=mode,
            call_device_ms=prof[2] / 5 if prof else None, **extra,
            sequence_device_ms=device_busy_ms(seq) if seq is not None else None)

    # layer 3 (32 heads, one window per clip, shift 0): K2 and K3 at HTSAT-tiny's
    # C=768, K5 and K3 at HTSAT-base's C=1024; LN1 runs before them in plain
    # PyTorch, as on the main path. Under AMP K5 also takes bf16 input.
    for c, name, kernel, plain in ((768, "fused_window_attention", k2.fused_window_attention,
                                    k2.window_attention_plain),
                                   (1024, "wide_window_attention", k5.wide_window_attention,
                                    k5.wide_attention_plain)):
        nh = 32
        flat, res = block(c, nh)
        hidden, r = 4 * c, B * 64
        x = t(B, 64, c, scale=0.5)
        y = layer_norm(x, flat[0], flat[1])
        for mode, md in modes:
            args = (y, *flat[2:6], flat[12], nh, 8, 1, 0, (8, 8), md)
            a = kernel(*args)
            stats.check(name, f"C={c}", a, plain(*args), mode)
            if md is not None and name == "wide_window_attention":
                bargs = (y.to(md), *args[1:])
                stats.check(name, f"C={c} bf16 input", kernel(*bargs), plain(*bargs), mode)
            # yardsticks: the function as F.linear -> SDPA (the same float
            # bias) -> F.linear, and SDPA on the attention core alone
            seq = attention_sequence(*args[1:6], nh, 8, 1, 0, (8, 8), md or torch.float32)
            qkv = (y.reshape(-1, c) @ flat[2].t() + flat[3]).reshape(B, 64, 3, nh, c // nh)
            q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3).to(md or torch.float32).contiguous()
                       for i in range(3))
            bias = k2.bias_and_mask(flat[12], 8, 0, (8, 8))[0][None].to(q.dtype)
            stats.time(name, f"C={c}", mode, lambda: kernel(*args), lambda: plain(*args),
                       2 * nbytes_of([y]) + nbytes_of(args[1:6]),
                       typed(mode, {"bf16": 8.0 * r * c * c + 4.0 * r * 64 * c}), launches=2,
                       library_fn=lambda: seq(y), library_what=ATTENTION_SEQUENCE,
                       route_flops={"tf32": 3 * 8.0 * r * c * c, "f32": 4.0 * r * 64 * c}
                       if md is None else None)
            log("kernels", kernel=name, shape=f"C={c}", mode=mode,
                yardstick_rel_err=rel_err(seq(y), plain(*args)),
                sdpa_core_ms=2 * time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=bias)))
            if md is not None:
                attention_launch(name, f"C={c}", mode, lambda: kernel(*args), r, c)
            else:
                golden_attention_launches(name, f"C={c}", lambda: kernel(*args), r, c)
                stats.check_f64(name, f"C={c}", kernel(*args), plain(*args),
                                f64.attention64(y, *args[1:6], nh, 8, 0, (8, 8)).reshape(y.shape))
            a = a.reshape(r, c)
            for use_res, dffn in ((False, False), (True, False), (True, True)):
                rp = dict(zip(("basis", "mean", "lam"), res)) if use_res else None
                fargs = (x.reshape(r, c), a, *flat[6:12], rp)
                label = f"C={c} res={use_res} dffn={dffn}"
                stats.check("fused_residual_ffn", label,
                            k3.fused_residual_ffn(*fargs, double_ffn=dffn, mxu_dtype=md),
                            k3.residual_ffn_plain(*fargs, double_ffn=dffn, mxu_dtype=md), mode)
                if use_res:
                    continue  # the main paths' layer 3 has no ResiDual
                seq = ffn_sequence(fargs, md or torch.float32)
                ops = 4.0 * r * c * hidden
                stats.time("fused_residual_ffn", label, mode,
                           lambda: k3.fused_residual_ffn(*fargs, mxu_dtype=md),
                           lambda: k3.residual_ffn_plain(*fargs, mxu_dtype=md),
                           3 * nbytes_of([x]) + nbytes_of(flat[6:12]),
                           typed(mode, {"bf16": ops}), launches=2,
                           library_fn=seq, library_what=FFN_SEQUENCE,
                           route_flops={"tf32": 3 * ops} if md is None else None)
                k3_device_time(label, fargs, md, mode, seq, ops)
                if md is None:
                    stats.check_f64("fused_residual_ffn", label,
                                    k3.fused_residual_ffn(*fargs),
                                    k3.residual_ffn_plain(*fargs), f64.ffn64(*fargs, False))

    # K5 at HTSAT-large's wide layers: layer 2 (C=1024, 16 heads, four windows
    # a clip, shifts 0 and 4) and layer 3 (C=2048, 32 heads, one window); then
    # at its edges: odd window counts (a window pair's second window missing)
    # and 7-wide windows (n = 49 tokens < 64, shift 3)
    for c, nh, windows, window, nw, hw, shifts in (
            (1024, 16, 4 * B, 8, 4, (16, 16), (0, 4)), (2048, 32, B, 8, 1, (8, 8), (0,)),
            (1024, 32, 3, 8, 1, (8, 8), (0,)), (1024, 16, 5, 8, 1, (8, 8), (0,)),
            (1024, 16, 8, 7, 4, (14, 14), (0, 3))):
        flat, _ = block(c, nh)
        table = t((2 * window - 1) ** 2, nh, scale=0.02)
        x = t(windows, window * window, c, scale=0.5)
        for mode, md in modes:
            for xin in (x,) if md is None else (x, x.to(md)):
                for shift in shifts:
                    args = (xin, *flat[2:6], table, nh, window, nw, shift, hw, md)
                    label = (f"C={c} nh={nh} windows={windows} n={window * window} "
                             f"shift={shift} x={xin.dtype}")
                    stats.check("wide_window_attention", label, k5.wide_window_attention(*args),
                                k5.wide_attention_plain(*args), mode)
                    if windows < B:
                        continue
                    # the large model's layers
                    if md is None:
                        stats.check_f64("wide_window_attention", label,
                                        k5.wide_window_attention(*args),
                                        k5.wide_attention_plain(*args),
                                        f64.attention64(x, *flat[2:6], table, nh, window, shift,
                                                        hw).reshape(x.shape))
                    call, rows = (lambda: k5.wide_window_attention(*args)), windows * window ** 2
                    if shift == 0 and xin is x and md is None:
                        golden_attention_launches("wide_window_attention", label, call, rows, c)
                    elif shift == 0 and xin is x:
                        attention_launch("wide_window_attention", label, mode, call, rows, c)

    # the shared AMP kernel at its edges through K2 and K4: 7-wide windows
    # (n = 49 < 64, shift 3) and odd window counts, at hd 24 and 32
    for c, nh, windows, window, nw, hw, shift in ((96, 4, 8, 7, 4, (14, 14), 3),
                                                 (768, 32, 3, 8, 1, (8, 8), 0),
                                                 (128, 4, 5, 8, 1, (8, 8), 0)):
        flat, res = block(c, nh)
        table = t((2 * window - 1) ** 2, nh, scale=0.02)
        x = t(windows, window * window, c, scale=0.5)
        flat = flat[:12] + (table,)
        label = f"C={c} nh={nh} windows={windows} n={window * window} shift={shift}"
        args = (x, *flat[2:6], table, nh, window, nw, shift, hw, torch.bfloat16)
        stats.check("fused_window_attention", label, k2.fused_window_attention(*args),
                    k2.window_attention_plain(*args), "bf16")
        blk = (x, flat + res, nh, window, nw, shift, hw, True, True, torch.bfloat16)
        stats.check("fused_swin_block", label, k4.fused_swin_block(*blk),
                    k4.swin_block_plain(*blk), "bf16")

    # the ResiDual alone, f32 in both modes, at a component count that is no
    # multiple of 8 (its products take it padded with zeros to 16): K3 with
    # zero FFN weights returns h1 = x + ResiDual(a) exactly (GELU(0) = 0)
    c, kr, r = 768, 13, B * 64
    _, res = block(c, 32)
    zeros = (torch.zeros(4 * c, c, device=dev), torch.zeros(4 * c, device=dev),
             torch.zeros(c, 4 * c, device=dev), torch.zeros(c, device=dev))
    rp = {"basis": res[0][:kr].contiguous(), "mean": res[1], "lam": res[2][:kr]}
    fargs = (t(r, c, scale=0.5), t(r, c, scale=0.1), t(c, scale=0.1, offset=1.0),
             t(c, scale=0.1), *zeros, rp)
    ref = f64.ffn64(*fargs, False)
    for mode, md in modes:
        label = f"ResiDual alone C={c} kr={kr} ({mode} route)"
        got = k3.fused_residual_ffn(*fargs, mxu_dtype=md)
        plain = k3.residual_ffn_plain(*fargs, mxu_dtype=md)
        stats.check("fused_residual_ffn", label, got, plain, "f32")
        stats.check_f64("fused_residual_ffn", label, got, plain, ref)


FFN_SEQUENCE = ("a sequence of calls, which the port never calls: F.layer_norm -> F.linear + "
                "F.gelu -> F.linear + add, on the same operands in the mode's type")


def ffn_sequence(fargs, md):
    """K3's function as PyTorch calls on operands of type ``md`` (cuBLAS
    products): the yardstick ``library_ms`` of K3, not a path of the port."""
    import torch.nn.functional as F

    x, a, n2s, n2b, w1, b1, w2, b2, _ = fargs
    w1b, b1b, w2b, b2b = (t.to(md) for t in (w1, b1, w2, b2))
    c = x.shape[-1]

    def run():
        h = x.float() + a.float()
        z = F.layer_norm(h, (c,), n2s, n2b).to(md)
        return h + F.linear(F.gelu(F.linear(z, w1b, b1b)), w2b, b2b)

    return run


STFT_CHAIN = ("a sequence of calls, which the port never calls: torch.stft (f32, hann, center, "
              "reflect) -> power -> the mel product -> dB, over all n_fft / 2 + 1 bins")


def stft_chain(cfg, dev):
    """K1's function as PyTorch calls in f32: ``run(wav [B, T])``, the
    golden yardstick ``stft_chain_ms``, not a path of the port."""
    import torch

    from audio_residual_tpu_torch.ops import frontend as fe

    window = torch.hann_window(cfg.win_length, periodic=True, device=dev)
    melw = torch.from_numpy(fe.mel_filterbank(cfg)).to(dev)
    offset = float(10.0 * np.log10(max(cfg.amin, cfg.ref)))

    def run(wav):
        spec = torch.stft(wav, cfg.n_fft, cfg.hop_length, cfg.win_length, window, center=True,
                          pad_mode="reflect", return_complex=True)
        power = spec.real ** 2 + spec.imag ** 2  # [B, n_fft / 2 + 1, frames]
        mel = power.transpose(1, 2) @ melw
        return 10.0 * torch.log10(torch.clamp(mel, min=cfg.amin)) - offset

    return run


ATTENTION_SEQUENCE = ("a sequence of calls, which the port never calls: F.linear -> SDPA with "
                      "the same float bias + mask -> F.linear, on the same operands")
BLOCK_SEQUENCE = ("a sequence of calls, which the port never calls: F.layer_norm -> "
                  "F.linear -> SDPA -> F.linear [-> ResiDual] + x -> F.layer_norm -> F.linear + "
                  "F.gelu -> F.linear + add [-> the double FFN], on the same operands")
ATTENTION_KERNELS = ("window_attention_wgmma",)  # the AMP qkv + attention launch


def rel_err(got, ref) -> float:
    return float((got.float() - ref.float()).abs().max() / ref.float().abs().max())


def attention_sequence(wqkv, bqkv, wproj, bproj, table, nh, window, nw, shift, res, dt):
    """K2's function as PyTorch calls in operand type ``dt`` (cuBLAS
    products, SDPA with the float bias + mask): ``run(y [W, n, C])``, the
    yardstick of K2 and of K4's attention half, not a path of the port."""
    import torch.nn.functional as F

    from audio_residual_tpu_torch.ops.cuda import window_attention as k2

    bias, mask = k2.bias_and_mask(table, window, shift, res)
    am = (bias[None] if mask is None else bias[None] + mask[:, None]).to(dt)  # [nW, nh, n, n]
    wq, bq, wp, bp = (w.to(dt) for w in (wqkv, bqkv, wproj, bproj))

    def run(y):
        wn, n, c = y.shape
        qkv = F.linear(y.to(dt), wq, bq).reshape(wn // nw, nw, n, 3, nh, c // nh)
        q, k, v = qkv.permute(3, 0, 1, 4, 2, 5).unbind(0)  # [B, nW, nh, n, hd]
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=am)
        return F.linear(o.permute(0, 1, 3, 2, 4).reshape(wn, n, c), wp, bp)

    return run


def block_sequence(args, dt):
    """K4's function as PyTorch calls (:func:`attention_sequence`, f32
    ResiDual and residual adds, cuBLAS FFN in operand type ``dt``): the
    yardstick ``library_ms`` of K4, not a path of the port."""
    import torch.nn.functional as F

    x, flat, nh, window, nw, shift, res, use_res, dffn, _ = args
    n1s, n1b, wqkv, bqkv, wproj, bproj, n2s, n2b, w1, b1, w2, b2, table, *rp = flat
    attn = attention_sequence(wqkv, bqkv, wproj, bproj, table, nh, window, nw, shift, res, dt)
    w1b, b1b, w2b, b2b = (w.to(dt) for w in (w1, b1, w2, b2))
    c = x.shape[-1]

    def ffn(t):
        z = F.layer_norm(t, (c,), n2s, n2b).to(dt)
        return F.linear(F.gelu(F.linear(z, w1b, b1b)), w2b, b2b).float()

    def run():
        xf = x.float()
        a = attn(F.layer_norm(xf, (c,), n1s, n1b)).float()
        if use_res:
            basis, mean, lam = rp
            a = ((a - mean) @ basis.t() * lam) @ basis
        h = xf + a
        out = h + ffn(h)
        if use_res and dffn:
            y2 = xf + out
            out = y2 + ffn(y2)
        return out.to(x.dtype)

    return run


def attention_launch(kernel, label, mode, call, r, c) -> None:
    """The qkv + attention launch of one AMP call by device time (2 r 3C C +
    4 r 64 C operations), beside all of the call's kernels: the
    window_attention_wgmma_kernel of K2, K4 and K5, one a call. A profiler
    window now and then drops kernel records:
    up to three windows are taken for one that holds all five launches,
    else the time is not measured (the card tests hold the count)."""
    ops = 6.0 * r * c * c + 4.0 * r * 64 * c
    call()
    a_ms = call_ms = launches = None
    for _ in range(3):
        prof = device_profile(lambda: [call() for _ in range(5)])
        if prof is None:
            continue
        launches = sum(v for n_, v in prof[4].items() if any(k in n_ for k in ATTENTION_KERNELS))
        if launches == 5:
            a_ms = sum(v for n_, v in prof[1].items()
                       if any(k in n_ for k in ATTENTION_KERNELS)) / 5
            call_ms = prof[2] / 5
            break
    log("kernels", kernel=kernel, shape=label, mode=mode, attention_launch_device_ms=a_ms,
        call_device_ms=call_ms, launches_in_window=launches,
        attention_launch_tflops=ops / a_ms / 1e9 if a_ms else None,
        attention_launch_peak_share=ops * 1e3 / a_ms / PEAK[mode] if a_ms else None)


def golden_attention_launches(kernel, label, call, r, c) -> None:
    """A golden K2 or K5 call by device time: its qkv and proj products on
    the 3xTF32 GEMM (2 r 4C C operations, three TF32 passes each) and the
    attention core, which must be the call's only kernels of the port, two
    and one a call. Up to three profiler windows are taken for one that
    holds all five calls' launches."""
    ops = 8.0 * r * c * c
    call()
    gemm_ms = core_ms = call_ms = None
    ours = collections.Counter()
    for _ in range(3):
        prof = device_profile(lambda: [call() for _ in range(5)])
        if prof is None:
            continue
        ours = port_kernels(prof[4])
        if ours == collections.Counter({"gemm_tf32x3_kernel": 10, "attention_core_kernel": 5}):
            gemm_ms = sum(v for n, v in prof[1].items() if "gemm_tf32x3_kernel" in n) / 5
            core_ms = sum(v for n, v in prof[1].items() if "attention_core_kernel" in n) / 5
            call_ms = prof[2] / 5
            break
        if set(ours) - GOLDEN_KERNELS:
            raise AssertionError(f"{kernel} {label}: golden calls launched {dict(ours)}")
    log("kernels", kernel=kernel, shape=label, mode="f32", tf32x3_gemms_device_ms=gemm_ms,
        attention_core_device_ms=core_ms, call_device_ms=call_ms,
        launches_in_window=json.dumps(dict(ours)),
        tf32x3_gemms_tflops=ops / gemm_ms / 1e9 if gemm_ms else None,
        tf32x3_peak_share=3 * ops * 1e3 / gemm_ms / PEAK["tf32"] if gemm_ms else None)


def port_kernels(counts: dict) -> collections.Counter:
    """{kernel name: launches} -> launches of the port's kernels by role
    (``PORT_KERNELS``); any other kernel of the port under its full name."""
    out = collections.Counter()
    for name, n in counts.items():
        key = next((k for k in PORT_KERNELS if f"{k}<" in name or f"{k}(" in name), None)
        if key is not None or "arpu::" in name:
            out[key or name] += n
    return out


def launches_named(prof, key: str) -> int:
    """Launches of the kernels whose name holds ``key`` in a profiler window."""
    return sum(n for name, n in prof[4].items() if key in name)


def log_profile(phase: str, label: str, prof, card: str | None = None) -> None:
    extra = {"card": card} if card else {}
    if prof is None:
        log(phase, profile=label, device_time="not measured")
        return
    groups, names, busy, span, _ = prof
    log(phase, profile=label, span_ms=span, busy_ms=busy, idle_share=1 - busy / span,
        by_group=json.dumps({k: round(v, 4) for k, v in groups.most_common()}), **extra)
    for name, ms in names.most_common(8):
        log(phase, profile=label, kernel=name[:110], device_ms=ms, **extra)


def gemm_specs():
    """``(label, M, N, K, epilogue, launches per forward)`` of every AMP GEMM
    on the two main paths at B=32. Epilogue keys: bias, col_scale, gelu,
    r1/r2 (their dtype), out (the output dtype)."""
    import torch

    f32, bf16 = torch.float32, torch.bfloat16
    specs = []
    # K4 at layers 0-2: (model, C, rows, launches, ResiDual + double FFN: layer 0, whose
    # activations are bf16 under AMP; layers 1-2 carry PatchMerging's f32)
    for model, c, r, n, res in (("tiny", 96, 131072, 2, True), ("tiny", 192, 32768, 2, False),
                                ("tiny", 384, 8192, 6, False), ("base", 128, 131072, 2, True),
                                ("base", 256, 32768, 2, False), ("base", 512, 8192, 12, False)):
        tag = f"{model} K4 C={c}"
        if res:
            specs += [(f"{tag} proj", r, c, c, dict(bias=True, out=f32), n),
                      (f"{tag} fc1", r, 4 * c, c, dict(bias=True, gelu=True, out=bf16), 2 * n),
                      (f"{tag} fc2+h1+x", r, c, 4 * c,
                       dict(bias=True, r1=f32, r2=bf16, out=f32), n),
                      (f"{tag} fc2+y2", r, c, 4 * c, dict(bias=True, r1=f32, out=bf16), n)]
        else:
            specs += [(f"{tag} proj+x", r, c, c, dict(bias=True, r1=f32, out=f32), n),
                      (f"{tag} fc1", r, 4 * c, c, dict(bias=True, gelu=True, out=bf16), n),
                      (f"{tag} fc2+h1", r, c, 4 * c, dict(bias=True, r1=f32, out=f32), n)]
    # layer 3 (2048 rows, f32 activations): K2's proj at tiny's C=768, K5's at
    # base's C=1024 (K3 runs its own clustered kernel there; the qkv products
    # of K2, K4 and K5 run inside the qkv + attention kernel)
    specs += [("tiny K2 C=768 proj", 2048, 768, 768, dict(bias=True, out=f32), 2),
              ("base K5 C=1024 proj", 2048, 1024, 1024, dict(bias=True, out=f32), 2)]
    return specs


def text_gemm_specs(layers: int = 12, d: int = 768, ff: int = 3072):
    """``gemm_specs``' rows for RoBERTa-base's AMP forward (phase 7): each
    layer's q, k, v, the attention output (+ the residual), fc1 (GELU, a
    bf16 store: its one reader rounds it to bf16) and fc2 (+ the residual),
    and the pooler, at the 50 prompts' and at 32 texts' 77 tokens."""
    import torch

    f32, bf16 = torch.float32, torch.bfloat16
    specs = []
    for b in (N_CLASSES, B):
        m = b * TEXT_CONTEXT
        tag = f"RoBERTa B={b}"
        specs += [(f"{tag} q|k|v", m, d, d, dict(bias=True, out=f32), 3 * layers),
                  (f"{tag} out+x", m, d, d, dict(bias=True, r1=f32, out=f32), layers),
                  (f"{tag} fc1", m, ff, d, dict(bias=True, gelu=True, out=bf16), layers),
                  (f"{tag} fc2+x", m, d, ff, dict(bias=True, r1=f32, out=f32), layers),
                  (f"{tag} pooler", b, d, d, dict(bias=True, out=f32), 1)]
    return specs


def phase_gemm(dev, specs=None, phase: str = "gemm",
               total_label: str = "summed over one AMP forward of each main path") -> None:
    """The AMP GEMM alone at each of ``specs`` (default: every main-path
    shape, ``gemm_specs()``): against its plain version, timed beside its
    bound and one torch.matmul of the same bf16 operands."""
    import torch

    from audio_residual_tpu_torch.ops.cuda import gemm as kg

    rng = np.random.default_rng(3)
    total = collections.Counter()
    for label, m, n, k, e, launches in specs if specs is not None else gemm_specs():
        def t(*shape, scale=1.0):
            a = (scale * rng.standard_normal(shape)).astype(np.float32)
            return torch.from_numpy(a).to(dev)

        a, w = t(m, k, scale=0.5).bfloat16(), t(n, k, scale=k ** -0.5).bfloat16()
        args = dict(bias=t(n, scale=0.02),
                    col_scale=(1 + t(n, scale=0.1)) if e.get("col_scale") else None,
                    gelu=e.get("gelu", False), out_dtype=e["out"],
                    r1=t(m, n).to(e["r1"]) if "r1" in e else None,
                    r2=t(m, n).to(e["r2"]) if "r2" in e else None)
        got, ref = kg.gemm(a, w, **args), kg.gemm_plain(a, w, **args)
        torch.cuda.synchronize()
        err = float((got.float() - ref.float()).abs().max())
        rel = err / float(ref.float().abs().max())
        tol = TOL["bf16"] if e["out"] == torch.bfloat16 else TOL["f32"]
        ok = bool(torch.isfinite(got.float()).all()) and rel < tol and got.dtype == ref.dtype
        nbytes = sum(x.numel() * x.element_size() for x in (a, w, got, *args.values())
                     if isinstance(x, torch.Tensor))
        b_ms, o_ms = 1e3 * nbytes / HBM_BYTES_S, 1e3 * 2.0 * m * n * k / PEAK["bf16"]
        ms = time_ms(lambda: kg.gemm(a, w, **args))
        plain = time_ms(lambda: kg.gemm_plain(a, w, **args))
        lib = time_ms(lambda: torch.matmul(a, w.t()))
        # device time alone: the events above also hold each call's host work
        dev_ms, lib_dev_ms = (device_busy_ms(f) for f in (lambda: kg.gemm(a, w, **args),
                                                          lambda: torch.matmul(a, w.t())))
        log(phase, shape=f"{label} [{m}x{k}]@[{n}x{k}]^T", launches=launches, max_abs_err=err,
            max_rel_err=rel, tol=tol, ok=ok, ms=ms, plain_ms=plain, bound_ms=max(b_ms, o_ms),
            bound_by="bytes" if b_ms >= o_ms else "operations", matmul_ms=lib,
            device_ms=dev_ms, matmul_device_ms=lib_dev_ms,
            tb_s=nbytes / dev_ms / 1e9 if dev_ms else None)
        if not ok:
            raise AssertionError(f"gemm {label} disagrees with its plain version")
        for key, v in (("ms", ms), ("plain_ms", plain), ("bound_ms", max(b_ms, o_ms)),
                       ("matmul_ms", lib)):
            total[key] += launches * v
        if dev_ms is not None and lib_dev_ms is not None:
            total["device_ms"] += launches * dev_ms
            total["matmul_device_ms"] += launches * lib_dev_ms
        else:
            total["shapes_without_device_time"] += 1
        total["launches"] += launches
    log(phase, total=total_label,
        **{k: total[k] for k in ("launches", "ms", "plain_ms", "bound_ms", "matmul_ms",
                                 "device_ms", "matmul_device_ms",
                                 "shapes_without_device_time")})


# the 3xTF32 linear at the contrastive cell's text batch: 96 texts of 77
# tokens; (N, K) of RoBERTa-base's q, k, v and out, fc1, fc2
LINEAR_M = 96 * TEXT_CONTEXT
LINEAR_SHAPES = ((768, 768), (3072, 768), (768, 3072))


def phase_linear(dev, card: str, stats: KernelStats | None = None) -> int:
    """Phase 2's 3xTF32 linear (``ops/cuda/linear.py``, RoBERTa's golden
    dense products on the card): forward and backward at M = 7392 for each
    of ``LINEAR_SHAPES``, with bias, without and with GELU, so the weight
    gradients run the split-K plans of the contrastive cell. y, dx, dW and
    db against ``linear_plain`` (``F.linear`` and its autograd, TF32 off)
    and against float64 (at most GOLDEN_F64_RATIO times ``linear_plain``'s
    error); the launches counted as they happen; forward + backward timed
    beside ``linear_plain`` and ``F.linear`` alone (its library yardstick),
    bound at the f32 rate and for 3xTF32's arithmetic. Returns the launches
    of those forward + backward passes."""
    import torch
    import torch.nn.functional as F

    from audio_residual_tpu_torch.ops.cuda import KERNELS, launch_counts
    from audio_residual_tpu_torch.ops.cuda import linear as kl
    from audio_residual_tpu_torch.ops.cuda.build import sm_count

    standalone = stats is None
    stats = stats or KernelStats(KERNELS)
    name, m = "linear_tf32x3", LINEAR_M
    rng = np.random.default_rng(24)
    total = 0
    with torch.enable_grad():
        for n, k in LINEAR_SHAPES:
            def t(*shape, scale=1.0):
                a = (scale * rng.standard_normal(shape)).astype(np.float32)
                return torch.from_numpy(a).to(dev)

            x, w, b, dy = t(m, k), t(n, k, scale=k ** -0.5), t(n, scale=0.1), t(m, n)
            plan = kl.weight_grad_plan(m, n, k, sm_count(dev))
            for gelu in (False, True):
                label = f"[{m}x{k}]@[{n}x{k}]^T{' gelu' if gelu else ''}"

                def run(fn, dt=torch.float32, gelu=gelu):
                    ins = [v.detach().to(dt).requires_grad_() for v in (x, w, b)]
                    y = fn(*ins, gelu=gelu)
                    return (y.detach(), *torch.autograd.grad(y, ins, dy.to(dt)))

                launch_counts.clear()
                got = run(kl.linear_tf32x3)
                torch.cuda.synchronize()
                counted = dict(launch_counts)
                want = {name: 1, f"{name}.dx": 1, f"{name}.dw": 1, "split_tf32": 2}
                log("kernels", kernel=name, shape=label, launches=json.dumps(counted),
                    expected=json.dumps(want), weight_grad_plan=json.dumps(
                        {"bn": plan.bn, "splits": plan.splits, "b_is_x": plan.b_is_x}))
                if counted != want:
                    raise AssertionError(f"{name} {label}: launched {counted}, expected {want}")
                total += sum(counted.values())
                plain, ref = run(kl.linear_plain), run(kl.linear_plain, torch.float64)
                for what, g, p_, r in zip(("y", "dx", "dW", "db"), got, plain, ref):
                    stats.check(name, f"{label} {what}", g, p_, "f32")
                    stats.check_f64(name, f"{label} {what}", g, p_, r)
                nbytes = 4 * 2 * (m * k + n * k + n + m * n)
                ops = 3 * 2.0 * m * n * k
                stats.time(name, label, "f32", lambda: run(kl.linear_tf32x3),
                           lambda: run(kl.linear_plain), nbytes, {"f32": ops},
                           library_fn=lambda: run(lambda *a, gelu: F.linear(*a)),
                           library_what="F.linear and its autograd, without the GELU",
                           route_flops={"tf32": 3 * ops})
    if standalone:
        print(stats.json_line({name: total}), flush=True)
        print(card, flush=True)
    return total


def main_inputs(cfg, dev) -> tuple:
    """The main path's ResiDual at layer 0 (an orthonormal basis from a
    seeded QR, K = C), its 50 class-text embeddings and 32 clips, made as
    bench.py makes them."""
    import torch

    from audio_residual_tpu_torch.residual.module import init_residual_params

    rng = np.random.default_rng(1)
    c = cfg.audio.embed_dim
    q, _ = np.linalg.qr(rng.standard_normal((c, c)))
    res0 = init_residual_params(q, rng.standard_normal(c) * 0.01, device=dev)
    res0["lam"] = torch.from_numpy((1 + 0.1 * rng.standard_normal(c)).astype(np.float32)).to(dev)
    text = np.random.default_rng(7).standard_normal((1, CLIP)).astype(np.float32) * 0.1
    text = torch.from_numpy(text[:, : N_CLASSES * 512].reshape(N_CLASSES, 512)).to(dev)
    text = text / text.norm(dim=-1, keepdim=True)
    wav = np.random.default_rng(123).standard_normal((B, CLIP)).astype(np.float32) * 0.1
    return {0: res0}, text, torch.from_numpy(wav).to(dev)


def phase_main(dev, card: str, label: str, build_model, expected: dict,
               golden_gemms: int) -> dict:
    """ESC-50 zero-shot + ResiDual at layer 0 through ``build_model()`` ->
    ``(model, cfg)``, golden and AMP; returns the AMP forward's launches.
    ``golden_gemms``: the 3xTF32 GEMMs of a golden forward."""
    import torch

    from audio_residual_tpu_torch.data.featurize import featurize_batch
    from audio_residual_tpu_torch.models.clap import encode_audio
    from audio_residual_tpu_torch.ops.cuda import launch_counts
    from audio_residual_tpu_torch.ops.quantize import quantize_roundtrip

    t0 = time.perf_counter()
    model, cfg = build_model()
    residual, text, wav = main_inputs(cfg, dev)
    log("main", model=label, batch=B, clip_samples=CLIP,
        residual_k=residual[0]["lam"].numel(), setup_s=time.perf_counter() - t0)

    def zero_shot(dtype):
        batch = featurize_batch(quantize_roundtrip(wav), cfg.audio.clip_samples)
        emb = encode_audio(model, batch, residual=residual, compute_dtype=dtype)["normalized"]
        return emb, (emb @ text.t()).argmax(-1)

    results, counts = {}, {}
    for mode, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        launch_counts.clear()
        emb, pred = zero_shot(dtype)
        torch.cuda.synchronize()
        counts[mode] = dict(launch_counts)
        if counts[mode] != expected:
            raise AssertionError(f"{label} {mode} main path launched {counts[mode]}, "
                                 f"expected {expected}")
        if emb.shape != (B, cfg.joint_embed_shape) or not bool(torch.isfinite(emb).all()):
            raise AssertionError(f"{label} {mode} embeddings malformed: {tuple(emb.shape)}")
        walls = []
        for _ in range(6):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            zero_shot(dtype)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
        wall = statistics.median(walls[1:])
        results[mode] = (emb, pred)
        log("main", model=label, mode=mode, launches=json.dumps(counts[mode]),
            clips_per_s=B / wall, forward_ms=1e3 * wall, card=card)
    # what casting the Swin weight matrices to bf16 costs; the wrappers keep
    # the copies per weight version, so a forward pays it only after an update
    from audio_residual_tpu_torch.models.htsat import SwinBlock

    mats = [p for blk in model.modules() if isinstance(blk, SwinBlock)
            for i, p in enumerate(blk.flat_params()) if i in (2, 4, 8, 10)]
    log("main", model=label,
        weight_cast_once_ms=time_ms(lambda: [w.to(torch.bfloat16) for w in mats]),
        weight_mats=len(mats), weight_mb=sum(w.numel() for w in mats) * 4 / 1e6)
    # K3's AMP call is one launch a pass: its kernel, once a call; every K2,
    # K4 and K5 call runs the qkv + attention kernel once, and none the
    # golden attention core; each ResiDual block its two f32 products on the
    # 3xTF32 GEMM
    want = sum(expected.get(k, 0) for k in ("fused_swin_block", "fused_window_attention",
                                             "wide_window_attention"))
    prof = profile_until(lambda: zero_shot(torch.bfloat16), lambda p: (
        launches_named(p, "ffn_cluster_kernel") == expected["fused_residual_ffn"]
        and launches_named(p, "window_attention_wgmma") == want), f"{label} bf16 forward")
    log_profile("main", f"{label} bf16 forward", prof)
    k3_kernels, tc, core, res_gemms = (launches_named(prof, k) for k in (
        "ffn_cluster_kernel", "window_attention_wgmma", "attention_core_kernel",
        "gemm_tf32x3_kernel"))
    log("main", model=label, k3_ffn_cluster_launches=k3_kernels,
        window_attention_wgmma_launches=tc, attention_core_launches=core,
        residual_tf32x3_gemm_launches=res_gemms)
    if k3_kernels != expected["fused_residual_ffn"]:
        raise AssertionError(f"{label}: {k3_kernels} ffn_cluster_kernel launches in the "
                             f"AMP forward, expected {expected['fused_residual_ffn']}")
    if tc != want or core or res_gemms != 2 * RESIDUAL_BLOCKS:
        raise AssertionError(f"{label}: the AMP forward launched window_attention_wgmma "
                             f"{tc} times (expected {want}), attention_core_kernel "
                             f"{core} times (expected 0) and gemm_tf32x3_kernel {res_gemms} "
                             f"times (expected {2 * RESIDUAL_BLOCKS}, the ResiDual's)")
    # the golden forward: K1 is one logmel_tf32x3_kernel, every product a
    # gemm_tf32x3_kernel, and no other kernel of the port runs but LayerNorm
    # and the attention core
    prof = profile_until(lambda: zero_shot(None), lambda p: (
        port_kernels(p[4])["gemm_tf32x3_kernel"] == golden_gemms
        and port_kernels(p[4])["logmel_tf32x3_kernel"] == 1), f"{label} f32 forward")
    log_profile("main", f"{label} f32 forward", prof)
    ours = port_kernels(prof[4])
    tf32x3, k1_golden = ours["gemm_tf32x3_kernel"], ours["logmel_tf32x3_kernel"]
    log("main", model=label, golden_tf32x3_gemm_launches=tf32x3,
        golden_logmel_tf32x3_launches=k1_golden, golden_port_kernels=json.dumps(dict(ours)))
    if tf32x3 != golden_gemms or k1_golden != 1 or set(ours) - GOLDEN_KERNELS:
        raise AssertionError(f"{label}: the golden forward launched gemm_tf32x3_kernel "
                             f"{tf32x3} times (expected {golden_gemms}), "
                             f"logmel_tf32x3_kernel {k1_golden} times (expected 1), and "
                             f"of the port's kernels {dict(ours)} (expected only "
                             f"{sorted(GOLDEN_KERNELS)})")
    (e32, p32), (e16, p16) = results["f32"], results["bf16"]
    cos = float((e16.float() * e32).sum(-1).min())
    agree = float((p16 == p32).float().mean())
    log("main", model=label, guard_min_embed_cos=cos, guard_argmax_agreement=agree)
    if not (agree == 1.0 and cos > 0.999):
        raise AssertionError(f"{label} AMP guard failed: min cos {cos}, argmax agreement {agree}")
    return counts["bf16"]


@contextlib.contextmanager
def plain_kernels():
    """The forward runs each kernel's plain version on the card: K1's
    ``logmel_plain`` (HTSAT's, PANN's and the fusion mel's), K4's
    ``swin_block_plain`` for layers 0-2, and the split
    plan -- layer 3, and every block of a tapped forward -- with K2's (or
    K5's) and K3's plain versions after its LN1; a training block with
    drop-path K2's plain version; RoBERTa's AMP products ``gemm_plain``,
    its golden ones ``F.linear``. The reference of the gradient and tap
    checks: the plain versions alone."""
    from unittest import mock

    from audio_residual_tpu_torch.models import htsat, roberta
    from audio_residual_tpu_torch.ops.cuda import frontend as k1
    from audio_residual_tpu_torch.ops.cuda import gemm as kg
    from audio_residual_tpu_torch.ops.cuda import ln_mlp as k3
    from audio_residual_tpu_torch.ops.cuda import swin_block as k4
    from audio_residual_tpu_torch.ops.cuda import window_attention as k2

    from audio_residual_tpu_torch.data import featurize
    from audio_residual_tpu_torch.models import pann

    with mock.patch.object(htsat, "fused_logmel", k1.logmel_plain), \
            mock.patch.object(pann, "fused_logmel", k1.logmel_plain), \
            mock.patch.object(featurize, "fused_logmel", k1.logmel_plain), \
            mock.patch.object(htsat, "fused_swin_block", k4.swin_block_plain), \
            mock.patch.object(htsat, "fused_window_attention", k2.window_attention_plain), \
            mock.patch.object(k4, "fused_window_attention", k2.window_attention_plain), \
            mock.patch.object(k4, "fused_residual_ffn", k3.residual_ffn_plain), \
            mock.patch.object(roberta, "gemm", kg.gemm_plain), \
            mock.patch.object(roberta, "takes", lambda x, w: False):
        yield


def cuda_ms_split(fns) -> list[float]:
    """Run ``fns`` in turn with a CUDA event between each: the ms of each."""
    import torch

    events = [torch.cuda.Event(enable_timing=True) for _ in range(len(fns) + 1)]
    events[0].record()
    for fn, event in zip(fns, events[1:]):
        fn()
        event.record()
    events[-1].synchronize()
    return [a.elapsed_time(b) for a, b in zip(events, events[1:])]


def phase_train(dev, card: str) -> None:
    """ResiDual λ-training on HTSAT-tiny at full width (the main path's
    seeded model, ResiDual at layer 0 with K = C = 96 and text embeddings;
    B=32 clips of 240 000 samples, labels from a seed): ``train_residual``
    golden, the step split golden and AMP, the λ-gradient against the plain
    versions', the JAX training fixture, the image cache's exactness, and
    the K-fold evaluation's outputs. Any miss raises."""
    import pickle
    import tempfile

    import torch

    from audio_residual_tpu_torch.data.featurize import featurize_batch
    from audio_residual_tpu_torch.evaluate.metrics import classification_metrics
    from audio_residual_tpu_torch.models.clap import CLAPConfig, build_clap_audio, encode_audio
    from audio_residual_tpu_torch.ops.cuda import launch_counts
    from audio_residual_tpu_torch.residual.module import (load_residual_params,
                                                          save_residual_params)
    from audio_residual_tpu_torch.training import train_residual as tr
    from tests import torch_port_fixture as fx

    cfg = CLAPConfig()
    model = build_clap_audio(cfg, seed=0, device=dev)
    residual, text, _ = main_inputs(cfg, dev)
    max_len = cfg.audio.clip_samples
    rng = np.random.default_rng(11)
    labels = torch.from_numpy(rng.integers(0, N_CLASSES, (TRAIN_BATCHES + 1, B))).to(dev)
    wavs = [torch.from_numpy((0.1 * rng.standard_normal((B, CLIP))).astype(np.float32)).to(dev)
            for _ in range(TRAIN_BATCHES + 1)]

    def train_batches():
        return zip(wavs[:TRAIN_BATCHES], labels[:TRAIN_BATCHES])

    modes = (("f32", None), ("bf16", torch.bfloat16))

    # train_residual, golden f32 as the JAX package runs it (auto: image cache)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trained, history = tr.train_residual(model, train_batches, text, residual,
                                         epochs=TRAIN_EPOCHS, lr=TRAIN_LR, max_len=max_len)
    torch.cuda.synchronize()
    moved = float((trained[0]["lam"] - residual[0]["lam"]).abs().max())
    ok = (all(np.isfinite(h["train_loss"]) for h in history) and moved > 0
          and torch.equal(trained[0]["basis"], residual[0]["basis"]))
    log("train", run="train_residual golden f32", epochs=TRAIN_EPOCHS, batches=TRAIN_BATCHES,
        batch=B, seconds=time.perf_counter() - t0, history=json.dumps(history),
        lam_max_move=moved, ok=ok, card=card)
    if not ok:
        raise AssertionError("train_residual: λ did not train, or a loss is not finite")

    # one step split into forward, backward and Adam by CUDA events, on the
    # image cache; its launches; the same step from the waveform
    images = tr.cache_prefix_images(model, train_batches(), max_len=max_len)
    for mode, md in modes:
        lam, frozen = tr._split_residual(residual)
        optimizer = tr.adam(lam, TRAIN_LR)
        step, loss_fn = tr.make_zero_shot_step(model, text, frozen, optimizer, max_len=max_len,
                                               compute_dtype=md, image_input=True)
        x, y = images[0]
        out = {}

        def forward():
            optimizer.zero_grad(set_to_none=True)
            out["loss"] = loss_fn(lam, x, y)[0]

        splits = []
        for i in range(TRAIN_TIMED_STEPS + 1):
            if i == 1:
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
            split = cuda_ms_split([forward, lambda: out["loss"].backward(), optimizer.step])
            if i:  # the first step warms up
                splits.append(split)
        peak = torch.cuda.max_memory_allocated()
        fwd, bwd, opt = (statistics.median(s[i] for s in splits) for i in range(3))
        step_ms = statistics.median(sum(s) for s in splits)
        launch_counts.clear()
        forward()
        fwd_counts = dict(launch_counts)
        launch_counts.clear()
        out["loss"].backward()
        optimizer.step()
        torch.cuda.synchronize()
        bwd_counts = dict(launch_counts)
        # device time by CUDA kernel over one step: the backward is PyTorch's
        log_profile("train", f"image-cached step, {mode}", device_profile(
            lambda: (forward(), out["loss"].backward(), optimizer.step())))
        uncached, _ = tr.make_zero_shot_step(model, text, frozen, optimizer, max_len=max_len,
                                             compute_dtype=md)
        uncached_ms = time_ms(lambda: uncached(lam, wavs[0], labels[0]), reps=TRAIN_TIMED_STEPS,
                              warmup=1)
        ok = fwd_counts == TRAIN_LAUNCHES and not bwd_counts
        log("train", step=f"image-cached, {mode}", forward_ms=fwd, backward_ms=bwd,
            optimizer_ms=opt, step_ms=step_ms, clips_per_s=B * 1e3 / step_ms,
            peak_allocated_gb=peak / 1e9, held_before_step_gb=held / 1e9,
            uncached_step_ms=uncached_ms, loss=float(out["loss"].detach()),
            launches_forward=json.dumps(fwd_counts), launches_backward=json.dumps(bwd_counts),
            ok=ok, card=card)
        if not ok:
            raise AssertionError(f"train step {mode}: forward launched {fwd_counts} (expected "
                                 f"{TRAIN_LAUNCHES}), backward {bwd_counts} (expected none)")

    # λ's gradient (kernel forward, plain-version backward) against autograd
    # through the plain versions alone, at full width, on GRAD_BATCHES
    # seeded batches: each batch logged, then the spread
    grad_rng = np.random.default_rng(13)
    grad_images = tr.cache_prefix_images(model, [
        (torch.from_numpy((0.1 * grad_rng.standard_normal((B, CLIP))).astype(np.float32)).to(dev),
         torch.from_numpy(grad_rng.integers(0, N_CLASSES, B)).to(dev))
        for _ in range(GRAD_BATCHES)], max_len=max_len)
    for mode, md in modes:
        lam, frozen = tr._split_residual(residual)
        _, loss_fn = tr.make_zero_shot_step(model, text, frozen, tr.adam(lam, TRAIN_LR),
                                            max_len=max_len, compute_dtype=md, image_input=True)
        rels, coss, oks = [], [], []
        for b, (x, y) in enumerate(grad_images):
            loss, _ = loss_fn(lam, x, y)
            (g,) = torch.autograd.grad(loss, [lam[0]])
            launch_counts.clear()
            with plain_kernels():
                loss_p, _ = loss_fn(lam, x, y)
                (g_p,) = torch.autograd.grad(loss_p, [lam[0]])
            torch.cuda.synchronize()
            rel = float((g - g_p).abs().max() / g_p.abs().max())
            cos = float((g * g_p).sum() / (g.norm() * g_p.norm()))
            ok = (not launch_counts and bool(torch.isfinite(g).all())
                  and (rel <= GRAD_REL if md is None else cos >= GRAD_COS))
            rels.append(rel), coss.append(cos), oks.append(ok)
            log("train", grad_check=mode, batch=b, loss=float(loss.detach()),
                plain_loss=float(loss_p.detach()), grad_max_abs=float(g_p.abs().max()),
                max_rel_err=rel, cosine=cos,
                limit=f"max_rel_err<={GRAD_REL}" if md is None else f"cosine>={GRAD_COS}",
                reference_launches=json.dumps(dict(launch_counts)), ok=ok)
        log("train", grad_check=mode, batches=len(coss), cosine_min=min(coss),
            cosine_max=max(coss), cosine_mean=statistics.mean(coss),
            cosine_stdev=statistics.stdev(coss), max_rel_err_min=min(rels),
            max_rel_err_max=max(rels), ok=all(oks))
        if not all(oks):
            raise AssertionError(f"λ-gradient ({mode}) disagrees with the plain versions' on "
                                 f"batches {[b for b, ok in enumerate(oks) if not ok]}")

    # the JAX training fixture, golden: loss, λ-gradient, λ after 3 Adam steps
    arrays = fx.load(fx.TRAIN_PATH)
    got = fx.run_port_train(arrays, dev)
    for key in fx.TRAIN_OUTPUT_KEYS:
        ref, val = arrays[f"out/{key}"], got[key]
        err = float(np.abs(val - ref).max())
        if key == "grad":
            cos = float((val * ref).sum() / (np.linalg.norm(val) * np.linalg.norm(ref)))
            ok = err <= 1e-4 * float(np.abs(ref).max()) and cos > 0.99999
            tol = "1e-4*max|g|, cosine>0.99999"
        else:
            kw = TRAIN_FIXTURE_TOL[key]
            ok = bool(np.allclose(val, ref, **kw))
            tol = ",".join(f"{k}={v}" for k, v in kw.items())
        log("fixture-train", output=key, max_abs_err=err, tol=tol, ok=ok)
        if not ok:
            raise AssertionError(f"fixture-train {key} disagrees with the JAX package")

    # the image cache: the resumed forward gives the uncached forward's bits;
    # λ after two steps from the cache and from the waveform agree
    for mode, md in modes:
        with torch.no_grad():
            batch = featurize_batch(wavs[0], max_len)
            full = encode_audio(model, batch, residual=residual, compute_dtype=md)["normalized"]
            image = encode_audio(model, batch, stop_at_image=True, compute_dtype=md)["image"]
            resumed = encode_audio(model, {"image": image}, residual=residual,
                                   compute_dtype=md)["normalized"]
        ok = torch.equal(full, resumed) and (md is not None or torch.equal(image, images[0][0]))
        log("train", cache_check=mode, embeddings_bit_equal=torch.equal(full, resumed),
            cached_image_bit_equal=torch.equal(image, images[0][0]) if md is None else None,
            ok=ok)
        if not ok:
            raise AssertionError(f"image-cache resume ({mode}) differs from the uncached forward")
    lams = []
    for cached in (True, False):
        lam, frozen = tr._split_residual(residual)
        step, _ = tr.make_zero_shot_step(model, text, frozen, tr.adam(lam, TRAIN_LR),
                                         max_len=max_len, image_input=cached)
        for b in range(2):
            step(lam, images[b][0] if cached else wavs[b], labels[b])
        lams.append(lam[0].detach())
    diff = float((lams[0] - lams[1]).abs().max())
    log("train", cache_check="λ after 2 steps, cached vs uncached", max_abs_diff=diff,
        atol=1e-6, ok=diff <= 1e-6)
    if diff > 1e-6:
        raise AssertionError(f"λ from the image cache differs from the uncached λ by {diff}")

    # evaluation of the trained λ on a held-out batch, and its artifacts
    preds, targets, sims = tr.evaluate_zero_shot(model, iter([(wavs[-1], labels[-1])]), text,
                                                 residual=trained, max_len=max_len)
    metrics = classification_metrics(sims, targets)
    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "ESC50", "ResiDual", "layers_0_evalfold_0.npz")
        pkl = os.path.join(tmp, "ESC50", "ResiDual", "lambda_layer0_evalfold_0.pkl")
        tr._kfold_npz(npz, preds, targets, sims)
        save_residual_params(pkl, trained[0])
        with np.load(npz) as d:
            npz_ok = (sorted(d.files) == ["predictions", "similarities", "targets"]
                      and np.array_equal(d["similarities"], sims))
        back = load_residual_params(pkl, device=dev)
        with open(pkl, "rb") as f:
            lam_back = pickle.load(f)["lam"]
        pkl_ok = (torch.equal(back["basis"], trained[0]["basis"])
                  and np.array_equal(lam_back, trained[0]["lam"].cpu().numpy()))
    ok = (sims.shape == (B, N_CLASSES) and bool(np.isfinite(sims).all()) and npz_ok and pkl_ok)
    log("train", eval="held-out batch, trained λ", accuracy=metrics["accuracy"],
        top5_accuracy=metrics["top5_accuracy"], f1_macro=metrics["f1_macro"],
        npz_written_and_read=npz_ok, lambda_pickle_written_and_read=pkl_ok, ok=ok)
    if not ok:
        raise AssertionError("evaluate_zero_shot: malformed similarities or artifacts")


def port_census(fn, want: dict, label: str, phase: str = "analysis") -> collections.Counter:
    """The port's kernels launched by ``fn()`` (``port_kernels`` of a
    profiler window, up to three until they are ``want``); the window's
    split is logged."""
    prof = profile_until(fn, lambda p: port_kernels(p[4]) == collections.Counter(want), label)
    log_profile(phase, label, prof)
    return port_kernels(prof[4])


@contextlib.contextmanager
def checked_split_plan(stats: KernelStats, label: str):
    """Every K2 (K5 from C >= 1024) and K3 call of the split plan checked
    against its plain version on the same inputs (``stats.check``, ``TOL``),
    K3 also the other way round: without the call's ResiDual, or, where the
    call has none, with a seeded one (K = C) and the double FFN. The
    kernels' outputs go on, so each call sees the tapped forward's own
    inputs."""
    from unittest import mock

    import torch

    from audio_residual_tpu_torch.ops.cuda import ln_mlp as k3
    from audio_residual_tpu_torch.ops.cuda import swin_block as k4
    from audio_residual_tpu_torch.ops.cuda import window_attention as k2
    from audio_residual_tpu_torch.residual.module import init_residual_params

    rng = np.random.default_rng(21)
    seeded = {}

    def attention(x, wqkv, bqkv, wproj, bproj, table, nh, window, nw, shift, resolution,
                  mxu_dtype=None):
        args = (x, wqkv, bqkv, wproj, bproj, table, nh, window, nw, shift, resolution,
                mxu_dtype)
        c = x.shape[-1]
        got = k2.fused_window_attention(*args)
        stats.check("wide_window_attention" if c >= k2.WIDE_MIN_C else "fused_window_attention",
                    f"{label} C={c} windows={x.shape[0]} nW={nw} shift={shift}", got,
                    k2.window_attention_plain(*args), "f32" if mxu_dtype is None else "bf16")
        return got

    def ffn(x, a, *weights, double_ffn=False, mxu_dtype=None):
        *weights, rparams = weights
        c = x.shape[-1]
        if rparams is None and c not in seeded:
            q, _ = np.linalg.qr(rng.standard_normal((c, c)))
            seeded[c] = init_residual_params(q, rng.standard_normal(c) * 0.01, device=x.device)
            lam = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
            seeded[c]["lam"] = torch.from_numpy(lam).to(x.device)
        got = None
        for rp, dffn in ((rparams, double_ffn),
                         (None, False) if rparams is not None else (seeded.get(c), True)):
            out = k3.fused_residual_ffn(x, a, *weights, rp, double_ffn=dffn, mxu_dtype=mxu_dtype)
            stats.check("fused_residual_ffn", f"{label} rows={x.shape[0]} C={c} "
                        f"residual={rp is not None} double_ffn={dffn}", out,
                        k3.residual_ffn_plain(x, a, *weights, rp, double_ffn=dffn,
                                              mxu_dtype=mxu_dtype),
                        "f32" if mxu_dtype is None else "bf16")
            got = out if got is None else got
        return got

    with mock.patch.object(k4, "fused_window_attention", attention), \
            mock.patch.object(k4, "fused_residual_ffn", ffn):
        yield


def tap_check(label: str, got: dict, ref: dict, keys, golden: bool) -> None:
    """Each tap (and each listed output) of ``got`` against ``ref``: golden
    within atol=2e-3, rtol=1e-3, the attention probabilities within
    atol=1e-5 (the CPU tests' bounds against the JAX package); AMP within
    ``TOL["bf16"]`` of max |ref| and cosine > ``TAP_AMP_COS``."""
    import torch

    for key in keys:
        pairs = list(zip(got[key], ref[key])) if key.startswith("layers_") else [
            (got[key], ref[key])]
        atol, rtol = (1e-5, 0.0) if key == "layers_attention" else (2e-3, 1e-3)
        for i, (g, r) in enumerate(pairs):
            g, r = g.float(), r.float()
            err = float((g - r).abs().max())
            rel = err / float(r.abs().max())
            cos = float((g.flatten() @ r.flatten()) / (g.norm() * r.norm()))
            close = (bool(torch.allclose(g, r, atol=atol, rtol=rtol)) if golden
                     else rel <= TOL["bf16"] and cos > TAP_AMP_COS)
            ok = g.shape == r.shape and bool(torch.isfinite(g).all()) and close
            log("analysis", check=f"{label} {key}[{i}]", shape=tuple(g.shape), max_abs_err=err,
                max_rel_err=rel, cosine=cos,
                tol=(f"atol={atol},rtol={rtol}" if golden
                     else f"max_rel_err<={TOL['bf16']},cosine>{TAP_AMP_COS}"), ok=ok)
            if not ok:
                raise AssertionError(f"{label}: {key}[{i}] disagrees with its reference")


def embedding_check(label: str, got, ref, text, golden: bool) -> None:
    """A tapped forward's embeddings against the untapped golden ones:
    golden within atol=2e-3, rtol=1e-3 and cosine > 0.99999; AMP within the
    bench guard (minimum cosine > 0.999, argmax agreement 1.0)."""
    import torch

    cos = float((got.float() * ref).sum(-1).min())
    agree = float(((got.float() @ text.t()).argmax(-1) == (ref @ text.t()).argmax(-1))
                  .float().mean())
    err = float((got.float() - ref).abs().max())
    ok = (bool(torch.allclose(got, ref, atol=2e-3, rtol=1e-3)) and cos > 0.99999 if golden
          else cos > 0.999 and agree == 1.0)
    log("analysis", check=f"{label} embedding against the untapped golden forward",
        max_abs_err=err, min_cosine=cos, argmax_agreement=agree,
        tol="atol=2e-3,rtol=1e-3,cosine>0.99999" if golden else "cosine>0.999,argmax=1.0",
        ok=ok)
    if not ok:
        raise AssertionError(f"{label}: the tapped embedding leaves the untapped one")


def tapped_forward(stats, label, model, batch, residual, text, md, taps, launches, census):
    """One tapped forward's checks: its launches, its embedding against the
    untapped golden forward, its taps and embedding against the same forward
    through the plain versions, each K2/K5 and K3 call against its plain
    version on the call's own inputs (``checked_split_plan``), its kernels
    by name (``census``), and its time beside the untapped forward's (CUDA
    events)."""
    import torch

    from audio_residual_tpu_torch.models.clap import encode_audio
    from audio_residual_tpu_torch.ops.cuda import launch_counts

    def run(taps_=taps, md_=md):
        return encode_audio(model, batch, taps=taps_, residual=residual, compute_dtype=md_)

    golden = md is None
    untapped = run((), None)["normalized"]
    launch_counts.clear()
    out = run()
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    log("analysis", forward=label, launches=json.dumps(counts))
    if counts != launches:
        raise AssertionError(f"{label}: launched {counts}, expected {launches}")
    embedding_check(label, out["normalized"], untapped, text, golden)
    launch_counts.clear()
    with plain_kernels():
        ref = run()
    torch.cuda.synchronize()
    if launch_counts:
        raise AssertionError(f"{label}: the plain route launched {dict(launch_counts)}")
    keys = [k for k in ("layers_attention", "layers_residuals") if k in out]
    tap_check(f"{label} against the plain versions", out, ref, [*keys, "normalized"], golden)
    with checked_split_plan(stats, f"{label} tapped"):
        run()
    ours = port_census(run, census, f"{label} forward")
    log("analysis", forward=label, port_kernels=json.dumps(dict(ours)),
        expected=json.dumps(census))
    if ours != collections.Counter(census):
        raise AssertionError(f"{label}: the port's kernels {dict(ours)}, expected {census}")
    ms, plain_ms = time_ms(run, reps=5, warmup=1), time_ms(lambda: run((), md), reps=5, warmup=1)
    log("analysis", forward=label, tapped_ms=ms, untapped_ms=plain_ms, batch=B)


def attention_pca_flops(cfg) -> float:
    """One batch's moment updates: per layer heads x rows (B x windows) x
    2 x (window^4)^2."""
    d = cfg.window_size ** 4
    return sum(2.0 * nh * B * (res // cfg.window_size) ** 2 * d * d
               for nh, res in zip(cfg.num_heads, (cfg.layer_resolution(i)[0]
                                                  for i in range(cfg.num_layers))))


def phase_analysis(stats: KernelStats, dev, card: str) -> None:
    """The paper's analysis pipeline on HTSAT-tiny at full width (the main
    path's seeded model, ResiDual and text embeddings; B=32 clips from a
    seed): tapped forwards, the residual PCA that λ-training reads, the three
    variants compared, the attention PCA checked against float64. Any miss
    raises."""
    import tempfile

    import torch

    from audio_residual_tpu_torch.data.featurize import featurize_batch
    from audio_residual_tpu_torch.evaluate import harness
    from audio_residual_tpu_torch.models.clap import CLAPConfig, build_clap_audio, encode_audio
    from audio_residual_tpu_torch.models.factory import create_audio_model
    from audio_residual_tpu_torch.ops import pca as pca_ops
    from audio_residual_tpu_torch.ops.quantize import quantize_roundtrip
    from audio_residual_tpu_torch.residual import analyze
    from audio_residual_tpu_torch.training import linear_probe
    from audio_residual_tpu_torch.training import train_residual as tr

    torch.cuda.reset_peak_memory_stats()
    cfg = CLAPConfig()
    model = build_clap_audio(cfg, seed=0, device=dev)
    residual, text, wav = main_inputs(cfg, dev)
    max_len = cfg.audio.clip_samples
    batch = featurize_batch(quantize_roundtrip(wav), max_len)
    blocks = sum(cfg.audio.depths)
    # the port's kernels a tapped forward launches, by name: K1; in every
    # block K3, a FFN pass (golden: add+LN2, fc1, fc2; AMP: one clustered
    # launch) and a second one in each ResiDual block (the double FFN), the
    # ResiDual's two 3xTF32 products there; under the residual tap K2 (golden:
    # qkv, the attention core, proj; AMP: the qkv + attention kernel and the
    # bf16 proj GEMM); nothing else -- no K4, whose LN1 is add_layernorm_kernel
    passes, res_gemms = blocks + RESIDUAL_BLOCKS, 2 * RESIDUAL_BLOCKS
    census = {
        ("residual", "f32"): {"logmel_tf32x3_kernel": 1, "attention_core_kernel": blocks,
                              "gemm_tf32x3_kernel": 2 * blocks + 2 * passes + res_gemms,
                              "add_layernorm_kernel": passes},
        ("residual", "bf16"): {"logmel_wgmma_kernel": 1, "window_attention_wgmma_kernel": blocks,
                               "gemm_kernel": blocks, "ffn_cluster_kernel": passes,
                               "gemm_tf32x3_kernel": res_gemms},
        ("attention", "f32"): {"logmel_tf32x3_kernel": 1,
                               "gemm_tf32x3_kernel": 2 * passes + res_gemms,
                               "add_layernorm_kernel": passes},
        ("attention", "bf16"): {"logmel_wgmma_kernel": 1, "ffn_cluster_kernel": passes,
                                "gemm_tf32x3_kernel": res_gemms},
    }
    for taps, launches in ((("residual",), TAPPED_LAUNCHES),
                           (("attention",), ATTENTION_TAP_LAUNCHES)):
        for mode, md in (("f32", None), ("bf16", torch.bfloat16)):
            tapped_forward(stats, f"HTSAT-tiny taps={taps[0]} {mode}", model, batch, residual,
                           text, md, taps, launches, census[(taps[0], mode)])
    base, base_cfg, _ = create_audio_model("HTSAT-base", seed=0, device=dev)
    base_res, base_text, _ = main_inputs(base_cfg, dev)
    # K2 and K5 launch the same kernels
    base_blocks = sum(base_cfg.audio.depths)
    passes = base_blocks + RESIDUAL_BLOCKS
    tapped_forward(stats, "HTSAT-base taps=residual bf16", base, batch, base_res, base_text,
                   torch.bfloat16, ("residual",), BASE_TAPPED_LAUNCHES,
                   {"logmel_wgmma_kernel": 1, "window_attention_wgmma_kernel": base_blocks,
                    "gemm_kernel": base_blocks, "ffn_cluster_kernel": passes,
                    "gemm_tf32x3_kernel": res_gemms})
    tapped_forward(stats, "HTSAT-base taps=residual f32", base, batch, base_res, base_text, None,
                   ("residual",), BASE_TAPPED_LAUNCHES,
                   {"logmel_tf32x3_kernel": 1, "attention_core_kernel": base_blocks,
                    "gemm_tf32x3_kernel": 2 * base_blocks + 2 * passes + res_gemms,
                    "add_layernorm_kernel": passes})
    del base

    # the pipeline: residual PCA per fold -> λ-training from its pickles,
    # the zero-shot baseline, the linear probe, the three variants
    rng = np.random.default_rng(17)
    wavs = [torch.from_numpy((0.1 * rng.standard_normal((B, CLIP))).astype(np.float32)).to(dev)
            for _ in range(ANALYSIS_BATCHES)]
    labels = [torch.from_numpy(rng.integers(0, N_CLASSES, B)).to(dev)
              for _ in range(ANALYSIS_BATCHES)]

    def split(idx):
        return lambda: iter([(wavs[i], labels[i]) for i in idx])

    folds = [(split([j for j in range(ANALYSIS_BATCHES) if j != i]), split([i]))
             for i in range(2)]

    def encode_residual(w):
        return encode_audio(model, featurize_batch(w, max_len), taps=("residual",))

    def encode_attention(w):
        return encode_audio(model, featurize_batch(w, max_len), taps=("attention",))

    c0 = cfg.audio.layer_dim(0)
    with tempfile.TemporaryDirectory() as tmp:
        pca_dir, out_dir = os.path.join(tmp, "pca"), os.path.join(tmp, "results")
        for i, (train, _) in enumerate(folds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = analyze.compute_pca_components(
                encode_residual, [w for w, _ in train()], 0, c0, device=dev,
                save_path=os.path.join(pca_dir, "ESC50", f"layer_0_evalfold_{i}"))
            seconds = time.perf_counter() - t0
            comps = res["components"]
            ortho = float(np.abs(comps @ comps.T - np.eye(c0)).max())
            rows = int(res["num_samples"])
            ok = (comps.shape == (c0, c0) and ortho < 1e-10
                  and rows == (ANALYSIS_BATCHES - 1) * B * cfg.audio.depths[0]
                  * cfg.audio.layer_resolution(0)[0] ** 2
                  and abs(float(res["explained_variance_ratio"].sum()) - 1.0) < 1e-9)
            log("analysis", stage=f"compute_pca_components fold {i}", layer=0, rows=rows,
                seconds=seconds, top_ratio=float(res["explained_variance_ratio"][0]),
                intrinsic_dim=analyze.intrinsic_dim(res["explained_variance_ratio"]),
                orthonormality_err=ortho, ok=ok)
            if not ok:
                raise AssertionError(f"compute_pca_components fold {i}: malformed result")
        t0 = time.perf_counter()
        results = tr.train_and_evaluate_residual(model, "ESC50", folds, text, pca_dir, out_dir,
                                                 epochs=ANALYSIS_EPOCHS, lr=TRAIN_LR)
        log("analysis", stage="train_and_evaluate_residual from the pickles",
            seconds=time.perf_counter() - t0,
            accuracy=json.dumps([r["accuracy"] for r in results]),
            loss=json.dumps([[h["train_loss"] for h in r["history"]] for r in results]))
        t0 = time.perf_counter()
        tr.evaluate_baseline_clap(model, "ESC50", folds, text, out_dir)
        log("analysis", stage="evaluate_baseline_clap", seconds=time.perf_counter() - t0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        probe = linear_probe.train_and_eval_linear_head(model, "ESC50", folds, N_CLASSES,
                                                        out_dir)
        torch.cuda.synchronize()
        probe_s = time.perf_counter() - t0
        feats = np.random.default_rng(18).standard_normal((2 * B, 512)).astype(np.float32)
        head_ms = cuda_ms_split([lambda: linear_probe.train_linear_head(
            0, feats, np.arange(2 * B) % N_CLASSES, N_CLASSES, device=dev)])[0]
        log("analysis", stage="train_and_eval_linear_head", seconds=probe_s,
            accuracy=json.dumps([r["accuracy"] for r in probe]),
            train_linear_head_ms=head_ms, head_rows=2 * B, epochs=20)
        table = harness.compare_variants(out_dir, "ESC50")
        for name in ("Baseline", "ResiDual", "Linear"):
            m = table.get(name)
            log("analysis", compare_variants=name, folds=m and m["folds"],
                accuracy_mean=m and m["accuracy_mean"], accuracy_std=m and m["accuracy_std"],
                top5_accuracy=m and m["top5_accuracy"])
        if set(table) != {"Baseline", "ResiDual", "Linear"} or any(
                m["folds"] != 2 for m in table.values()):
            raise AssertionError(f"compare_variants found {sorted(table)}")

        # the attention PCA: run_pca over the attention tap, then the moment
        # update and the finalize timed alone on the same batches
        heads = cfg.audio.num_heads
        attn_wavs = wavs[:ATTENTION_PCA_BATCHES]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        spectra = analyze.run_pca(encode_attention, attn_wavs, cfg.audio.num_layers, heads,
                                  device=dev)
        torch.cuda.synchronize()
        run_pca_s = time.perf_counter() - t0
        ap = analyze.AttentionPCA(heads, device=dev)
        update_ms = []
        for w in attn_wavs:
            with torch.no_grad():
                taps_out = encode_attention(w)["layers_attention"]
            update_ms.append(cuda_ms_split([lambda: ap.update(taps_out)])[0])
        flops = attention_pca_flops(cfg.audio)
        moments_gb = sum(st.outer.numel() * 4 for st in ap.states) / 1e9
        log("analysis", stage="attention PCA update a batch", ms=json.dumps(update_ms),
            median_ms=statistics.median(update_ms), gflop=flops / 1e9,
            f32_bound_ms=1e3 * flops / PEAK["f32"], moments_gb=moments_gb,
            run_pca_seconds=run_pca_s)
        finalized = {}
        finalize_ms = cuda_ms_split([lambda: finalized.update(ap.finalize())])[0]
        same = all(np.allclose(finalized[k]["explained_variance"],
                               spectra[k]["explained_variance"], rtol=1e-9, atol=0)
                   for k in spectra)
        k = spectra[(0, 0)]["n_components"]
        log("analysis", stage="attention PCA randomized finalize", ms=finalize_ms,
            heads=len(spectra), k=k, float64_gflop=sum(
                h * 8 * 2.0 * (4096 ** 2) * (k + 16) for h in heads) / 1e9,
            same_as_run_pca=same)
        if not same or set(spectra) != {(i, h) for i, nh in enumerate(heads) for h in range(nh)}:
            raise AssertionError("run_pca and the timed AttentionPCA disagree")
        for layer in (0, cfg.audio.num_layers - 1):
            st = ap.states[layer]
            n = st.n[0].double()
            mean = st.sum[0].double() / n
            cov = (st.outer[0].double() - n * torch.outer(mean, mean)) / (n - 1)
            w64, v64 = torch.linalg.eigh(cov)
            top = PCA_F64_CHECK["top"]
            w64, v64 = w64.flip(-1)[:top].cpu().numpy(), v64.flip(-1)[:, :top].cpu().numpy()
            got = pca_ops.pca_finalize(pca_ops.PCAState(*(t[:1] for t in st)))
            ev = got["explained_variance"][0][:top]
            span = np.linalg.norm(got["components"][0][:top] @ v64, axis=1)
            rel = float(np.abs(ev / w64 - 1).max())
            ok = rel <= PCA_F64_CHECK["rtol"] and float(span.min()) > PCA_F64_CHECK["span"]
            log("analysis", check=f"attention PCA layer {layer} head 0 against float64 eigh",
                rows=int(n), top=top, eigenvalue_max_rel_err=rel, span_norm_min=float(span.min()),
                top_eigenvalue=float(w64[0]), last_checked_eigenvalue=float(w64[-1]),
                tol=f"rtol={PCA_F64_CHECK['rtol']},span>{PCA_F64_CHECK['span']}", ok=ok)
            if not ok:
                raise AssertionError(f"attention PCA layer {layer}: the randomized finalize "
                                     "leaves the float64 eigh")
        path = analyze.save_pca_results_on_file(tmp, "ESC50", 0, spectra)
        back = analyze.load_pca_csv_results(path)
        ok = set(back) == set(spectra) and all(
            len(back[key]["explained_variance"]) == k for key in back)
        for layer, nh in enumerate(heads):
            log("analysis", attention_pca_layer=layer, heads=nh,
                intrinsic_dim_mean=statistics.mean(back[(layer, h)]["intrinsic_dim"]
                                                   for h in range(nh)),
                participation_ratio_mean=statistics.mean(back[(layer, h)]["participation_ratio"]
                                                         for h in range(nh)))
        log("analysis", csv_rows=sum(len(v["explained_variance"]) for v in back.values()),
            csv_read_back=ok, peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
            card=card)
        if not ok:
            raise AssertionError("the attention PCA's CSV does not read back")


def phase_qr(stats: KernelStats, dev, card: str) -> int:
    """Phase 6b: the blocked Householder QR at each layer's ``[heads, 4096,
    784]`` against the library's QR, timed beside its bound and the
    library's (its ``KERNELS`` row: the 28 calls of one ``run_pca``); the
    device time of ``QR_SHAPE`` by kernel; one run_pca of the attention tap
    counted. Returns that count. Any miss raises."""
    import torch

    from audio_residual_tpu_torch.data.featurize import featurize_batch
    from audio_residual_tpu_torch.models.clap import CLAPConfig, build_clap_audio, encode_audio
    from audio_residual_tpu_torch.ops.cuda import launch_counts, qr
    from audio_residual_tpu_torch.residual import analyze

    _, d, m = QR_SHAPE
    eye = torch.eye(m, dtype=torch.float64, device=dev)
    row = stats.rows["householder_qr"]
    for heads in QR_HEADS:
        shape = (heads, d, m)
        g = torch.Generator(device=dev).manual_seed(23 + heads)
        a = torch.randn(shape, generator=g, dtype=torch.float64, device=dev)
        q, ref = qr.householder_qr(a), qr.householder_qr_plain(a)
        ortho = float((q.mT @ q - eye).abs().max())
        resid = float((torch.linalg.norm(q @ (q.mT @ a) - a, dim=(-2, -1))
                       / torch.linalg.norm(a, dim=(-2, -1))).max())
        signs = torch.sign(torch.diagonal(ref.mT @ q, dim1=-2, dim2=-1))
        err = float((q - ref * signs[:, None, :]).abs().max())
        ok = ortho <= 1e-12 and resid <= 1e-12 and err <= 1e-10
        log("qr", check=f"householder_qr {list(shape)} against torch.linalg.qr",
            orthonormality_err=ortho, span_residual=resid, max_abs_err_to_signs=err,
            tol="1e-12,1e-12,1e-10", plan=json.dumps(qr.qr_plan(d, m)._asdict()), ok=ok)
        if not ok:
            raise AssertionError("householder_qr leaves the library's QR")
        row["max_abs_err"] = max(row["max_abs_err"], err)
        del q, ref
        stats.time("householder_qr", f"{list(shape)} float64", "f64",
                   lambda: qr.householder_qr(a), lambda: qr.householder_qr_plain(a),
                   nbytes=2 * a.numel() * 8,
                   flops={"f64": heads * (4 * d * m * m - 4 / 3 * m ** 3)},
                   launches=QR_PER_LAYER, library_fn=lambda: torch.linalg.qr(a).Q,
                   library_what="torch.linalg.qr(a).Q")
        if shape == QR_SHAPE:
            prof = profile_until(lambda: qr.householder_qr(a), lambda p: True, "householder_qr")
            ours = port_kernels(prof[4])
            log("qr", device_ms=prof[2], by_kernel=json.dumps(
                {k: round(v, 4) for k, v in prof[1].most_common(8)}),
                launches=sum(prof[4].values()), port=json.dumps(dict(ours)), card=card)
            if not ours["householder_panel_kernel"]:
                raise AssertionError(f"householder_qr: no panel kernel of the port among {ours}")
        del a

    # one run_pca of the attention tap: every block through the kernel
    cfg = CLAPConfig()
    model = build_clap_audio(cfg, seed=0, device=dev)
    wav = torch.from_numpy((0.1 * np.random.default_rng(24).standard_normal((B, CLIP))
                            ).astype(np.float32)).to(dev)
    library_calls = []
    library_qr = torch.linalg.qr

    def counted(x, *args, **kwargs):
        if x.is_cuda:
            library_calls.append(tuple(x.shape))
        return library_qr(x, *args, **kwargs)

    launch_counts.clear()
    torch.linalg.qr = counted
    try:
        analyze.run_pca(lambda w: encode_audio(model, featurize_batch(w, cfg.audio.clip_samples),
                                               taps=("attention",)),
                        [wav], cfg.audio.num_layers, cfg.audio.num_heads, device=dev)
    finally:
        torch.linalg.qr = library_qr
    calls = launch_counts["householder_qr"]
    ok = calls == RUN_PCA_QR_CALLS and not library_calls
    log("qr", check="run_pca of the attention tap", householder_qr=calls,
        expected=RUN_PCA_QR_CALLS, library_qr_on_card=len(library_calls), ok=ok)
    if not ok:
        raise AssertionError("run_pca does not orthonormalise through householder_qr alone")
    del model, wav
    torch.cuda.empty_cache()  # the float64 blocks and the model leave the allocator
    return calls


def text_flops(cfg, tokens: int, texts: int) -> dict:
    """The operations of ``encode_text`` on RoBERTa/BERT at ``texts`` rows
    of ``tokens / texts`` tokens, by kind: the dense products (and the
    pooler and projection) and the attention's two products a head."""
    t = cfg.text
    d, ff, layers = t.hidden_size, t.intermediate_size, t.num_layers
    length = tokens // texts
    dense = 2 * tokens * layers * (4 * d * d + 2 * d * ff)
    dense += 2 * texts * (d * d + d * cfg.joint_embed_shape + cfg.joint_embed_shape ** 2)
    attention = 2 * 2 * texts * layers * length * length * d
    return {"dense": dense, "attention": attention}


def text_bound_ms(cfg, tokens: int, texts: int, amp: bool) -> tuple[float, str]:
    """``encode_text``'s bound on the card: the larger of its weights and
    activations over HBM and its operations over the peak of their type
    (dense products bf16 under AMP, f32 golden; the attention products f32
    in both modes: bf16-rounded operands in an f32 product)."""
    f = text_flops(cfg, tokens, texts)
    ops_ms = 1e3 * (f["dense"] / PEAK["bf16" if amp else "f32"] + f["attention"] / PEAK["f32"])
    t = cfg.text
    weights = 4 * t.num_layers * (4 * t.hidden_size ** 2 + 2 * t.hidden_size * t.intermediate_size)
    bytes_ms = 1e3 * (weights / (2 if amp else 1) + 4 * tokens * t.hidden_size * 2) / HBM_BYTES_S
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def text_check(label: str, got, ref, golden: bool) -> None:
    """Text features against a reference: golden within ``GOLDEN_TEXT``
    (float64 reference); AMP within the bench guard's cosine > 0.999."""
    import torch

    g, r = got.double(), ref.double()
    cos = float(((g * r).sum(-1) / (g.norm(dim=-1) * r.norm(dim=-1))).min())
    err = float((g - r).abs().max())
    finite = bool(torch.isfinite(got).all())
    if golden:
        ok = finite and bool(torch.allclose(g, r, atol=GOLDEN_TEXT["atol"],
                                            rtol=GOLDEN_TEXT["rtol"])) and cos > GOLDEN_TEXT["cos"]
        tol = "atol=2e-3,rtol=1e-3,cosine>0.99999"
    else:
        ok, tol = finite and cos > 0.999, "cosine>0.999"
    log("clap", check=label, shape=list(got.shape), max_abs_err=err, min_cosine=cos, tol=tol,
        ok=ok)
    if not ok:
        raise AssertionError(f"{label}: outside {tol}")


def clap_batches() -> list:
    """Phase 7's zero-shot data: CLAP_BATCHES seeded batches of B
    ESC-50-length clips (numpy, as a user hands them to ``CLAPModule``) with
    seeded labels."""
    rng = np.random.default_rng(29)
    return [((rng.standard_normal((B, CLIP)) * 0.1).astype(np.float32),
             rng.integers(0, N_CLASSES, B)) for _ in range(CLAP_BATCHES)]


def phase_clap(dev, card: str) -> None:
    """ESC-50 zero-shot with a real text classifier, the slice's path:
    ``CLAPModule`` (HTSAT-tiny + RoBERTa-base at full width, seed 0), the 50
    prompts through the text tower, two seeded batches of B clips through
    K1, K4, K2, K3, ``evaluate_zeroshot``; golden and AMP modules. Beside it
    the text tower against float64, the AMP text route's bf16 GEMMs at their
    shapes, ``clap_apply`` at B clips + B texts, the JAX CLAP fixture for
    every tower, times and peak memory. Any miss raises."""
    import copy

    import torch

    from audio_residual_tpu_torch.data.featurize import featurize_batch
    from audio_residual_tpu_torch.evaluate.zero_shot import (PROMPT_TEMPLATES,
                                                             build_text_classifier,
                                                             evaluate_zeroshot)
    from audio_residual_tpu_torch.models.clap import (apply_transform, clap_apply, encode_audio,
                                                      encode_text)
    from audio_residual_tpu_torch.module import CLAPModule
    from audio_residual_tpu_torch.ops.cuda import launch_counts
    from audio_residual_tpu_torch.ops.quantize import quantize_roundtrip
    from audio_residual_tpu_torch.utils.tokenizer import HashTokenizer
    from tests import torch_port_fixture as fx

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tok = HashTokenizer(context_length=TEXT_CONTEXT)
    golden = CLAPModule(device=dev, seed=0, tokenizer=tok)
    amp = CLAPModule(device=dev, seed=0, tokenizer=tok, compute_dtype=torch.bfloat16)
    model, cfg = golden.model, golden.cfg
    with open(os.path.join(REPO, "class_labels", "ESC50_class_labels_indices_space.json")) as f:
        labels = list(json.load(f))
    prompts = [PROMPT_TEMPLATES["default"].format(c) for c in labels]
    texts = {N_CLASSES: tok(prompts), B: tok([f"{p} {i}" for i, p in enumerate(prompts[:B])])}
    texts = {b: {k: torch.from_numpy(v).to(dev) for k, v in enc.items()}
             for b, enc in texts.items()}
    log("clap", modules="CLAPModule(HTSAT-tiny, roberta) golden + AMP", tokenizer="HashTokenizer",
        prompts=len(prompts), context=TEXT_CONTEXT,
        text_params=sum(p.numel() for p in model.text_branch.parameters()),
        setup_s=time.perf_counter() - t0)

    with torch.no_grad():
        # the text tower at full width: golden against a float64 copy on the
        # card, AMP against golden; the AMP route's bf16 GEMM launches
        ref64 = copy.deepcopy(model).double()
        golden_text = {}
        for b, enc in texts.items():
            args = (enc["input_ids"], enc["attention_mask"])
            launch_counts.clear()
            golden_text[b] = encode_text(model, *args)
            torch.cuda.synchronize()
            if not golden_text_census_ok(dict(launch_counts)):
                raise AssertionError(f"golden text forward launched {dict(launch_counts)}, "
                                     f"expected {TEXT_LINEARS} 3xTF32 linears")
            text_check(f"golden text B={b} against float64", golden_text[b],
                       encode_text(ref64, *args), golden=True)
            launch_counts.clear()
            amp_text = encode_text(model, *args, compute_dtype=torch.bfloat16)
            torch.cuda.synchronize()
            got = dict(launch_counts)
            log("clap", text_b=b, amp_launches=json.dumps(got), expected={"gemm": TEXT_GEMMS})
            if got != {"gemm": TEXT_GEMMS}:
                raise AssertionError(f"AMP text forward launched {got}, expected "
                                     f"{TEXT_GEMMS} bf16 GEMMs")
            text_check(f"AMP text B={b} against golden", amp_text, golden_text[b], golden=False)
        classifier = build_text_classifier(golden, labels)
        if not np.array_equal(classifier, golden_text[N_CLASSES].cpu().numpy()):
            raise AssertionError("build_text_classifier differs from encode_text's features")
        del ref64
    phase_gemm(dev, text_gemm_specs(cfg.text.num_layers, cfg.text.hidden_size,
                                    cfg.text.intermediate_size),
               "clap", "summed over one AMP text forward of 50 prompts and one of 32 texts")

    # the path: evaluate_zeroshot on seeded batches, golden and AMP modules
    batches = clap_batches()
    embeds, metrics = {}, {}
    for mode, module in (("f32", golden), ("bf16", amp)):
        launch_counts.clear()
        metrics[mode] = evaluate_zeroshot(module, batches, labels)
        torch.cuda.synchronize()
        got = dict(launch_counts)
        want = {k: CLAP_BATCHES * v for k, v in EXPECTED_LAUNCHES.items()}
        log("clap", mode=mode, evaluate_zeroshot_launches=json.dumps(got),
            expected=json.dumps(want))
        # the classifier: one golden text forward of the prompts (both
        # modules keep the text side f32)
        text = {k: got.pop(k) for k in ("linear_tf32x3", "split_tf32") if k in got}
        if got != want or not golden_text_census_ok(text):
            raise AssertionError(f"evaluate_zeroshot ({mode}) launched {got} and {text}, "
                                 f"expected {want} and {TEXT_LINEARS} 3xTF32 linears")
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            evaluate_zeroshot(module, batches, labels)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
        wall = statistics.median(walls[1:])
        log("clap", mode=mode, evaluate_zeroshot_ms=1e3 * wall,
            clips_per_s=CLAP_BATCHES * B / wall, classifier_builds=1, card=card,
            metrics=json.dumps({k: v for k, v in metrics[mode].items() if np.isscalar(v)}))
        wav = batches[0][0]
        embeds[mode] = module.get_audio_embedding_from_data(wav)
        want_census = CLAP_CENSUS[mode]
        census = port_census(lambda: module.get_audio_embedding_from_data(wav), want_census,
                             f"{mode} audio forward of CLAPModule", "clap")
        log("clap", mode=mode, census=json.dumps(dict(census)))
        if census != collections.Counter(want_census):
            raise AssertionError(f"{mode} audio forward ran {dict(census)}, expected "
                                 f"{want_census}")
    cos = float((embeds["f32"] * embeds["bf16"]).sum(-1).min())
    agree = float(((embeds["f32"] @ classifier.T).argmax(-1)
                   == (embeds["bf16"] @ classifier.T).argmax(-1)).mean())
    log("clap", guard_min_embed_cos=cos, guard_argmax_agreement=agree)
    if not (cos > 0.999 and agree == 1.0):
        raise AssertionError(f"CLAPModule AMP guard failed: min cos {cos}, argmax {agree}")
    if not np.array_equal(amp.get_text_embedding(prompts), classifier):
        raise AssertionError("the AMP module's text side is not the golden module's")

    with torch.no_grad():
        # clap_apply at B clips + B texts: its features are encode_audio's and
        # encode_text's in the same mode, bit for bit
        wav = torch.from_numpy(batches[0][0]).to(dev)
        batch = featurize_batch(quantize_roundtrip(wav), cfg.audio.clip_samples)
        enc = texts[B]
        heads = {side: copy.deepcopy(getattr(model, f"{side}_transform")).double()
                 for side in ("audio", "text")}
        for mode, md in (("f32", None), ("bf16", torch.bfloat16)):
            out = clap_apply(model, batch, enc["input_ids"], enc["attention_mask"],
                             compute_dtype=md)
            same = (torch.equal(out["audio_features"],
                                encode_audio(model, batch, compute_dtype=md)["normalized"])
                    and torch.equal(out["text_features"],
                                    encode_text(model, enc["input_ids"], enc["attention_mask"],
                                                compute_dtype=md)))
            scales = [float(out[k]) for k in ("logit_scale_a", "logit_scale_t")]
            scales_ok = all(abs(v * 0.07 - 1) < 1e-6 for v in scales)
            log("clap", mode=mode, clap_apply_features_equal=same, logit_scales=scales,
                ok=same and scales_ok)
            if not (same and scales_ok):
                raise AssertionError(f"clap_apply ({mode}) features or logit scales are off")
            for side in ("audio", "text"):
                ref = apply_transform(heads[side], out[f"{side}_features"].double())
                text_check(f"clap_apply {mode} {side}_features_mlp against float64",
                           out[f"{side}_features_mlp"], ref, golden=True)
            log("clap", mode=mode, clap_apply_ms=time_ms(lambda: clap_apply(
                model, batch, enc["input_ids"], enc["attention_mask"], compute_dtype=md), reps=5),
                batch=B, texts=B, card=card)

        # times of the text tower beside its bound, and the AMP text forward
        # by CUDA kernel
        for b, enc in texts.items():
            args = (enc["input_ids"], enc["attention_mask"])
            for mode, md in (("f32", None), ("bf16", torch.bfloat16)):
                bound, by = text_bound_ms(cfg, b * TEXT_CONTEXT, b, md is not None)
                log("clap", text_b=b, tokens=b * TEXT_CONTEXT, mode=mode,
                    ms=time_ms(lambda: encode_text(model, *args, compute_dtype=md)),
                    bound_ms=bound, bound_by=by,
                    tflop=sum(text_flops(cfg, b * TEXT_CONTEXT, b).values()) / 1e12, card=card)
        enc = texts[N_CLASSES]
        prof = profile_until(
            lambda: encode_text(model, enc["input_ids"], enc["attention_mask"],
                                compute_dtype=torch.bfloat16),
            lambda p: port_kernels(p[4])["gemm_kernel"] == TEXT_GEMMS, "AMP text forward")
        log_profile("clap", "AMP text forward, 50 prompts", prof)
        if port_kernels(prof[4])["gemm_kernel"] != TEXT_GEMMS:
            raise AssertionError(f"AMP text forward: {dict(port_kernels(prof[4]))} in the "
                                 f"profile, expected {TEXT_GEMMS} gemm_kernel")
    log("clap", peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9, card=card)

    # the JAX CLAP fixture, every text tower, golden
    arrays = fx.load(fx.CLAP_PATH)
    for tmodel in fx.CLAP_TEXT_KW:
        got = fx.run_port_clap(arrays, tmodel, dev)
        for key in fx.CLAP_APPLY_KEYS:
            ref = arrays[f"out/{tmodel}/{key}"]
            err = float(np.abs(got[key] - ref).max())
            ok = bool(np.allclose(got[key], ref, atol=2e-3, rtol=1e-3))
            log("fixture-clap", tower=tmodel, output=key, max_abs_err=err,
                tol="atol=2e-3,rtol=1e-3", ok=ok)
            if not ok:
                raise AssertionError(f"fixture-clap {tmodel} {key} disagrees with the JAX package")


CONTRASTIVE_STEPS = 4  # AdamW steps of the loop, each mode
CONTRASTIVE_TIMED = 3  # timed steps, each split
# a rate small enough for the first-order decrease to rule at random weights:
# Adam moves each of the 157M weights by about the rate (at 1e-4 the loop's
# loss jumps about on the card)
CONTRASTIVE_OPT = dict(lr=3e-6, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.2, warmup=1,
                       total_steps=20)


def contrastive_batch(tok, dev) -> dict:
    """Phase 8's fixed batch, B pairs that differ from each other, as a
    contrastive batch's do: B ESC-50-length clips from seed 31, each three
    tones of its own (log-uniform 100 Hz - 8 kHz) under an envelope of its
    own over white noise, repeat-padded to the model's 10 s; and the names
    of the first B ESC-50 classes, 77 tokens each (at random weights
    RoBERTa's pooled features of texts that share most words lie within
    cosine 0.99 of each other, where bf16's rounding moves them by 2e-5)."""
    import torch

    from audio_residual_tpu_torch.data.featurize import featurize_batch

    rng = np.random.default_rng(31)
    t = np.arange(CLIP) / 48000.0
    freqs = np.exp(rng.uniform(np.log(100.0), np.log(8000.0), (B, 3, 1)))
    tones = (rng.uniform(0.02, 0.1, (B, 3, 1))
             * np.sin(2 * np.pi * freqs * t + rng.uniform(0, 2 * np.pi, (B, 3, 1)))).sum(1)
    envelope = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(0.2, 4.0, (B, 1)) * t)
    wav = (tones * envelope + 0.02 * rng.standard_normal((B, CLIP))).astype(np.float32)
    with open(os.path.join(REPO, "class_labels", "ESC50_class_labels_indices_space.json")) as f:
        labels = list(json.load(f))[:B]
    enc = tok(labels)
    return {"waveform": featurize_batch(torch.from_numpy(wav).to(dev), 480000)["waveform"],
            **{k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in enc.items()}}


def mean_pair_cosine(f) -> float:
    """The mean cosine between the batch's distinct rows of ``f``: how far
    apart the pairs the loss tells apart lie."""
    f = f.detach().double()
    f = f / f.norm(dim=-1, keepdim=True)
    n = f.shape[0]
    return float(((f @ f.T).sum() - n) / (n * (n - 1)))


def tower_of(name: str) -> str:
    if name.startswith("logit_scale"):
        return "logit_scales"
    return "audio" if name.startswith("audio_") else "text"


def grads_of(model, towers, batch, plain: bool) -> tuple:
    """Loss and every parameter's gradient of one step's forward and
    backward, no randomness; on the plain route with ``plain``."""
    import torch

    from audio_residual_tpu_torch.training.losses import clip_loss

    model.zero_grad(set_to_none=True)
    with plain_kernels() if plain else contextlib.nullcontext():
        out = towers(batch["waveform"], batch["input_ids"], batch["attention_mask"], None)
        loss = clip_loss(out)
        loss.backward()
    torch.cuda.synchronize()
    spread = {k: mean_pair_cosine(out[k]) for k in ("audio_features", "text_features")}
    return float(loss.detach()), {n: p.grad.detach().clone() for n, p in model.named_parameters()
                                  if p.grad is not None}, spread


def _cosine(g, h, names) -> float:
    dot = sum(float((g[n].double() * h[n].double()).sum()) for n in names)
    ng = sum(float(g[n].double().pow(2).sum()) for n in names) ** 0.5
    nh = sum(float(h[n].double().pow(2).sum()) for n in names) ** 0.5
    return dot / (ng * nh) if ng * nh > 0 else 1.0


def contrastive_grad_check(model, towers, batch, mode: str, golden: bool,
                           golden_grads=None) -> dict:
    """One step's gradients, kernels against the plain route on the card, a
    tower at a time; the worst parameter named. Golden: max rel err <=
    GRAD_REL. AMP: cosine >= GRAD_COS, or, where bf16 alone moves the plain
    route further from ``golden_grads`` (the golden step's gradients) than
    that, >= the plain route's own cosine against them: at random weights
    RoBERTa's gradient moves by a cosine of 0.99 under bf16 rounding on the
    card, and no bf16 route can be held closer to another than that. Returns the kernel route's gradients."""
    from audio_residual_tpu_torch.ops.cuda import launch_counts

    loss, g, spread = grads_of(model, towers, batch, plain=False)
    launch_counts.clear()
    loss_p, g_p, _ = grads_of(model, towers, batch, plain=True)
    log("contrastive", grad_check=mode, features_mean_pair_cosine=json.dumps(spread))
    plain_launches = dict(launch_counts)
    if set(g) != set(g_p) or plain_launches:
        raise AssertionError(f"contrastive {mode}: gradients of {sorted(set(g) ^ set(g_p))} "
                             f"differ in presence; plain route launched {plain_launches}")
    oks = []
    for tower in ("audio", "text", "logit_scales"):
        names = [n for n in g if tower_of(n) == tower]
        diff = max(float((g[n] - g_p[n]).abs().max()) for n in names)
        scale = max(float(g_p[n].abs().max()) for n in names)
        cos = _cosine(g, g_p, names)
        floor = {}
        limit = GRAD_COS
        if golden_grads is not None:
            floor = {"kernel_route_against_golden": _cosine(g, golden_grads, names),
                     "plain_route_against_golden": _cosine(g_p, golden_grads, names)}
            limit = min(GRAD_COS, floor["plain_route_against_golden"])
        worst = max(names, key=lambda n: float((g[n] - g_p[n]).abs().max())
                    / max(float(g_p[n].abs().max()), 1e-30))
        rel = diff / scale if scale > 0 else 0.0
        ok = bool(np.isfinite(rel)) and (rel <= GRAD_REL if golden else cos >= limit)
        oks.append(ok)
        log("contrastive", grad_check=mode, tower=tower, params=len(names), loss=loss,
            plain_loss=loss_p, max_rel_err=rel, cosine=cos, worst_param=worst,
            worst_param_rel_err=float((g[worst] - g_p[worst]).abs().max()
                                      / max(float(g_p[worst].abs().max()), 1e-30)),
            limit=f"max_rel_err<={GRAD_REL}" if golden else f"cosine>={limit}",
            bf16_cosines=json.dumps(floor), ok=ok)
    if not all(oks):
        raise AssertionError(f"contrastive {mode}: a tower's gradient disagrees with the plain "
                             "route's")
    return g


def kernels_at_current_weights(model, batch, md, mode: str) -> None:
    """Every K4 and K2 call of one training forward (no randomness, no
    graph) against its plain version on the call's own inputs: after the
    optimizer's in-place updates, a stale derived weight copy would show
    here."""
    from unittest import mock

    import torch

    from audio_residual_tpu_torch.models import htsat
    from audio_residual_tpu_torch.models.clap import clap_apply
    from audio_residual_tpu_torch.ops.cuda import swin_block as k4
    from audio_residual_tpu_torch.ops.cuda import window_attention as k2

    errs = collections.defaultdict(list)
    real4, real2 = htsat.fused_swin_block, htsat.fused_window_attention

    def k4_checked(x, flat, *args):
        out = real4(x, flat, *args)
        errs["fused_swin_block"].append(rel_err(out, k4.swin_block_plain(x, flat, *args)))
        return out

    def k2_checked(x, *args):
        out = real2(x, *args)
        errs["fused_window_attention"].append(rel_err(out, k2.window_attention_plain(x, *args)))
        return out

    with mock.patch.object(htsat, "fused_swin_block", k4_checked), \
            mock.patch.object(htsat, "fused_window_attention", k2_checked), torch.no_grad():
        clap_apply(model, {"waveform": batch["waveform"]}, batch["input_ids"],
                   batch["attention_mask"], train=True, compute_dtype=md)
    tol = TOL["f32" if md is None else "bf16"]
    ok = all(e <= tol for v in errs.values() for e in v) and len(errs) == 2
    log("contrastive", kernels_at_updated_weights=mode,
        calls=json.dumps({k: len(v) for k, v in errs.items()}),
        max_rel_err=json.dumps({k: max(v) for k, v in errs.items()}), tol=tol, ok=ok)
    if not ok:
        raise AssertionError(f"contrastive {mode}: a kernel at the updated weights disagrees "
                             f"with its plain version: {dict(errs)}")


def phase_contrastive(dev, card: str) -> None:
    """CLAP training on the card, the slice's path: ``CLAPModule()``'s model
    (HTSAT-tiny + RoBERTa-base, seed 0) through ``make_train_step`` and the
    loop ``main`` runs per epoch, golden f32 and bf16 AMP, on a fixed batch
    of B clips and B texts (module docstring, phase 8). Any miss raises."""
    import tempfile

    import torch

    from audio_residual_tpu_torch.module import CLAPModule
    from audio_residual_tpu_torch.ops.cuda import build, launch_counts
    from audio_residual_tpu_torch.parallel.mesh import data_parallel_mesh
    from audio_residual_tpu_torch.training import checkpoints
    from audio_residual_tpu_torch.training import train_clap as tc
    from audio_residual_tpu_torch.training.losses import clip_loss
    from audio_residual_tpu_torch.training.main import epoch_generator, train_one_epoch
    from audio_residual_tpu_torch.utils.tokenizer import HashTokenizer
    from tests import torch_port_fixture as fx

    torch.cuda.reset_peak_memory_stats()
    tok = HashTokenizer(context_length=TEXT_CONTEXT)
    module = CLAPModule(device=dev, seed=0, tokenizer=tok)
    model, cfg = module.model, module.cfg
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    batch = contrastive_batch(tok, dev)
    mesh = data_parallel_mesh(device=dev)
    golden_grads = None
    log("contrastive", model="CLAPModule(HTSAT-tiny, roberta)", batch=B, clip=CLIP,
        context=TEXT_CONTEXT, params=sum(p.numel() for p in model.parameters()),
        drop_path_rate=cfg.audio.drop_path_rate, optimizer=json.dumps(CONTRASTIVE_OPT))
    for mode, md in (("f32", None), ("bf16", torch.bfloat16)):
        model.load_state_dict(init)
        optimizer = tc.make_optimizer(model, **CONTRASTIVE_OPT)
        state = tc.init_train_state(model, optimizer)
        towers = tc.ClapTowers(model, compute_dtype=md)
        step_fn = tc.make_train_step(model, optimizer, compute_dtype=md)

        grads = contrastive_grad_check(model, towers, batch, mode, golden=md is None,
                                       golden_grads=golden_grads)
        golden_grads = grads if md is None else None
        del grads

        # the launch census of one training forward, by the JAX dispatch
        want = dict(fx.expected_launches(cfg.audio, train=True), **text_launches(md))
        want = {k: v for k, v in want.items() if v}
        launch_counts.clear()
        with torch.no_grad():
            towers(batch["waveform"], batch["input_ids"], batch["attention_mask"], 0)
        torch.cuda.synchronize()
        census = dict(launch_counts)
        log("contrastive", census=mode, launches=json.dumps(census), expected=json.dumps(want),
            ok=census == want)
        if census != want:
            raise AssertionError(f"contrastive {mode}: a training forward launched {census}, "
                                 f"the JAX dispatch gives {want}")

        # the loop main runs per epoch, counts from 0 before it; the size of
        # the derived-weight caches after each step
        losses, cache_sizes = [], []

        def logged_step(st, b, g):
            st, m = step_fn(st, b, g)
            losses.append(m)
            cache_sizes.append(len(build._derived))
            return st, m

        def fixed_loss():  # the fixed batch's training loss without randomness
            with torch.no_grad():
                return float(clip_loss(towers(batch["waveform"], batch["input_ids"],
                                              batch["attention_mask"], None)))

        loss_before = fixed_loss()
        bn0_before = model.audio_branch.bn0.running_mean.detach().clone()
        launch_counts.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_one_epoch(state, logged_step, [batch] * CONTRASTIVE_STEPS, epoch=0, mesh=mesh,
                        generator=epoch_generator(0, 0))
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        loop_launches = dict(launch_counts)
        loss_after = fixed_loss()
        vals = [float(m["loss"]) for m in losses]
        scales = [float(m["logit_scale_a"]) for m in losses]
        moved = float((model.audio_branch.bn0.running_mean - bn0_before).abs().max())
        # a step: the forward's census, with the golden text tower's backward
        step_want = dict(want, **text_launches(md, train_step=True))
        want_loop = {k: v * CONTRASTIVE_STEPS for k, v in step_want.items()}
        ok = (all(np.isfinite(vals)) and loss_after < loss_before
              and max(scales) <= tc.MAX_LOGIT_SCALE + 1e-6 and moved > 0
              and loop_launches == want_loop and cache_sizes[-1] == cache_sizes[0])
        log("contrastive", loop=mode, steps=CONTRASTIVE_STEPS, seconds=loop_s,
            fixed_batch_loss_before=loss_before, fixed_batch_loss_after=loss_after,
            losses=json.dumps(vals), grad_norms=json.dumps([float(m["grad_norm"])
                                                            for m in losses]),
            logit_scale_a=json.dumps(scales), bn0_running_mean_max_move=moved,
            launches=json.dumps(loop_launches), expected=json.dumps(want_loop),
            derived_cache_sizes=json.dumps(cache_sizes), ok=ok, card=card)
        if not ok:
            raise AssertionError(f"contrastive {mode}: the fixed batch's loss did not fall, a scale "
                                 "passed ln(100), bn0 did not move, its launches differ from "
                                 "the census, or the derived-weight caches grew")

        kernels_at_current_weights(model, batch, md, mode)

        # one step split by CUDA events: forward, backward, optimizer
        out = {}

        def forward():
            optimizer.zero_grad(set_to_none=True)
            o = towers(batch["waveform"], batch["input_ids"], batch["attention_mask"], 7)
            out["loss"] = clip_loss(o)

        splits = []
        for i in range(CONTRASTIVE_TIMED + 1):
            if i == 1:
                torch.cuda.reset_peak_memory_stats()
            split = cuda_ms_split([forward, lambda: out["loss"].backward(), optimizer.step])
            if i:
                splits.append(split)
        peak = torch.cuda.max_memory_allocated()
        fwd, bwd, opt = (statistics.median(s[i] for s in splits) for i in range(3))
        step_ms = time_ms(lambda: step_fn(state, batch, torch.Generator().manual_seed(3)),
                          reps=CONTRASTIVE_TIMED, warmup=1)
        log("contrastive", step=mode, forward_ms=fwd, backward_ms=bwd, optimizer_ms=opt,
            split_sum_ms=fwd + bwd + opt, backward_share=bwd / (fwd + bwd + opt),
            train_step_ms=step_ms, clips_per_s=B * 1e3 / step_ms,
            peak_allocated_gb=peak / 1e9, card=card)
        log_profile("contrastive", f"train step, {mode}", device_profile(
            lambda: step_fn(state, batch, torch.Generator().manual_seed(4))))

        if md is None:
            # save -> resume reproduces the next step bit for bit
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                with tempfile.TemporaryDirectory() as tmp:
                    path = checkpoints.save_checkpoint(tmp, state, 0, "contrastive")
                    size = os.path.getsize(path)
                    step_fn(state, batch, torch.Generator().manual_seed(5))
                    after = {k: v.detach().clone() for k, v in model.state_dict().items()}
                    checkpoints.load_checkpoint(path, state)
                    step_fn(state, batch, torch.Generator().manual_seed(5))
                    torch.cuda.synchronize()
                same = [k for k, v in model.state_dict().items() if torch.equal(v, after[k])]
            finally:
                torch.use_deterministic_algorithms(False)
            ok = len(same) == len(after)
            log("contrastive", checkpoint="save -> resume -> next step", file_gb=size / 1e9,
                tensors=len(after), bit_equal=len(same), ok=ok)
            if not ok:
                raise AssertionError("contrastive: the resumed step differs from the uninterrupted "
                                     f"one in {len(after) - len(same)} tensors")
        del state, optimizer, step_fn, towers
        torch.cuda.empty_cache()
    log("contrastive", peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9, card=card)


TOWER_LAUNCHES = {"fused_logmel": 1}  # a PANN forward: K1 and cuDNN's convs
FUSION_LONG, FUSION_SHORT = 960000, 240000  # 20 s clips (longer) and 5 s clips
FUSION_LAUNCHES = {"fused_logmel": B, "fused_swin_block": 10, "fused_window_attention": 2,
                   "fused_residual_ffn": 2}  # featurization: K1 one a clip
FOLD_CLIPS = 8  # 9c's ESC-50-shaped tree: clips a fold, two folds


def golden_check(phase: str, label: str, got, ref, cos: bool = True) -> None:
    """``got`` against ``ref`` at the golden parity (atol 2e-3, rtol 1e-3;
    cosine > 0.99999 a row where ``cos``)."""
    import torch

    g, r = got.double(), ref.double()
    err = float((g - r).abs().max())
    c = float(((g * r).sum(-1) / (g.norm(dim=-1) * r.norm(dim=-1))).min())
    ok = (bool(torch.isfinite(got).all()) and got.shape == ref.shape
          and bool(torch.allclose(g, r, atol=2e-3, rtol=1e-3)) and (c > 0.99999 or not cos))
    log(phase, check=label, shape=list(got.shape), max_abs_err=err, min_cosine=c,
        tol="atol=2e-3,rtol=1e-3" + (",cosine>0.99999" if cos else ""), ok=ok)
    if not ok:
        raise AssertionError(f"{phase} {label}: outside the golden parity")


def guard_check(phase: str, label: str, golden, amp, text) -> None:
    """The bench guard: AMP against golden embeddings, min cosine > 0.999 and
    argmax agreement 1.0 against ``text``."""
    g, a = golden.float(), amp.float()
    cos = float((g * a).sum(-1).min())
    agree = float(((g @ text.t()).argmax(-1) == (a @ text.t()).argmax(-1)).float().mean())
    ok = cos > 0.999 and agree == 1.0
    log(phase, guard=label, min_embed_cos=cos, argmax_agreement=agree, ok=ok)
    if not ok:
        raise AssertionError(f"{phase} {label}: AMP guard failed (cos {cos}, argmax {agree})")


def census_check(phase: str, label: str, want: dict) -> None:
    import torch

    from audio_residual_tpu_torch.ops.cuda import launch_counts

    torch.cuda.synchronize()
    got = {k: v for k, v in launch_counts.items() if v}
    log(phase, census=label, launches=json.dumps(got), expected=json.dumps(want),
        ok=got == want)
    if got != want:
        raise AssertionError(f"{phase} {label}: launched {got}, expected {want}")


def host_ms(fn, reps: int = 5) -> float:
    """Median host-clock ms of ``reps`` synchronised calls, after one."""
    import torch

    fn()
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(walls)


def tower_timing(phase: str, label: str, fn, card: str, clips: int = B) -> None:
    """Host ms and clips/s (median of 5), CUDA-event ms, one profiler window
    (busy, idle share, device ms by kernel)."""
    ms = host_ms(fn)
    log(phase, model=label, host_ms=ms, clips_per_s=1e3 * clips / ms,
        cuda_event_ms=time_ms(fn, reps=5, warmup=1), card=card)
    log_profile(phase, label, profile_until(fn, lambda p: True, label))


def write_wav(path, samples, sr: int) -> None:
    """``samples [T, channels]`` in [-1, 1) as PCM16, to a path or a file
    object."""
    import wave

    with wave.open(path if hasattr(path, "write") else str(path), "wb") as w:
        w.setnchannels(samples.shape[1])
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((samples * 32767).astype(np.int16).tobytes())


def phase_towers(dev, card: str, stats: KernelStats | None = None) -> None:
    """Phase 9 (module docstring): PANN, mel fusion, the file and fold entry
    points; K1's checks go into ``stats`` (a fresh one when alone). Any miss
    raises."""
    import tempfile
    import wave

    import torch

    from audio_residual_tpu_torch import native
    from audio_residual_tpu_torch.data import featurize
    from audio_residual_tpu_torch.evaluate import eval_zeroshot_classification
    from audio_residual_tpu_torch.evaluate.zero_shot import PROMPT_TEMPLATES
    from audio_residual_tpu_torch.models.clap import CLAPConfig, encode_audio
    from audio_residual_tpu_torch.models.factory import create_audio_model, create_model
    from audio_residual_tpu_torch.module import CLAPModule
    from audio_residual_tpu_torch.ops.cuda import frontend as k1
    from audio_residual_tpu_torch.ops.cuda import launch_counts
    from audio_residual_tpu_torch.ops.quantize import quantize_roundtrip
    from audio_residual_tpu_torch.training import lp_main
    from audio_residual_tpu_torch.utils.tokenizer import HashTokenizer
    from tests import torch_f64_reference as f64
    from tests import torch_port_fixture as fx

    from audio_residual_tpu_torch.ops.cuda import KERNELS

    phase = "towers"
    stats = stats or KernelStats(KERNELS)
    started = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(41)
    _, text, _ = main_inputs(CLAPConfig(), dev)  # 50 seeded unit text embeddings

    # 9a: PANN-14 through create_model, golden and AMP, ESC-50-length clips
    t0 = time.perf_counter()
    model, cfg, _ = create_model("PANN-14", "roberta", seed=0, device=dev)
    wav = torch.from_numpy((0.1 * rng.standard_normal((B, CLIP))).astype(np.float32)).to(dev)
    with torch.no_grad():
        batch = featurize.featurize_batch(quantize_roundtrip(wav), cfg.audio.clip_samples)
        log(phase, model="PANN-14 (create_model, roberta)", batch=B, clip_samples=CLIP,
            padded_to=cfg.audio.clip_samples, embed_dim=cfg.embed_dim,
            audio_params=sum(p.numel() for p in model.audio_branch.parameters()),
            setup_s=time.perf_counter() - t0)
        out = {}
        for mode, md in (("f32", None), ("bf16", torch.bfloat16)):
            launch_counts.clear()
            out[mode] = encode_audio(model, batch, compute_dtype=md)["normalized"]
            census_check(phase, f"PANN-14 {mode} forward", TOWER_LAUNCHES)
        same = torch.equal(out["f32"], out["bf16"])
        log(phase, model="PANN-14", amp_equals_golden=same,
            why="clap_apply passes no compute_dtype to a PANN tower: f32 in both modes")
        if not same:
            raise AssertionError("PANN-14: the AMP forward is not the f32 one")
        with plain_kernels():
            ref = encode_audio(model, batch)["normalized"]
        golden_check(phase, "PANN-14 embedding against the plain route", out["f32"], ref)
        guard_check(phase, "PANN-14", out["f32"], out["bf16"], text)
        tower_timing(phase, "PANN-14 forward B=32", lambda: encode_audio(model, batch), card)
        log(phase, model="PANN-14", peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
            card=card)
        del model
        torch.cuda.reset_peak_memory_stats()
        for name, n in (("PANN-6", CLIP), ("PANN-10", CLIP), ("PANN-14-fmax-8k-20s", 2 * CLIP)):
            tower, tcfg, _ = create_audio_model(name, seed=0, device=dev)
            w = torch.from_numpy((0.1 * rng.standard_normal((B, n))).astype(np.float32)).to(dev)
            b = featurize.featurize_batch(w, tcfg.audio.clip_samples)
            if name.endswith("20s"):
                check_logmel(stats, f"{name} [32,{tcfg.audio.clip_samples}] hop "
                             f"{tcfg.audio.hop_size}", b["waveform"],
                             tcfg.audio.frontend_config, "f32")
            launch_counts.clear()
            o = encode_audio(tower, b)["normalized"]
            census_check(phase, f"{name} forward", TOWER_LAUNCHES)
            finite = bool(torch.isfinite(o).all()) and o.shape == (B, tcfg.joint_embed_shape)
            log(phase, model=name, clip_samples=tcfg.audio.clip_samples,
                embed_dim=tcfg.embed_dim, finite=finite,
                cuda_event_ms=time_ms(lambda: encode_audio(tower, b), reps=3, warmup=1),
                card=card)
            if not finite:
                raise AssertionError(f"{name}: embeddings malformed")
            del tower
    log(phase, stage="Cnn6, Cnn10, PANN-14-fmax-8k-20s",
        peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9, card=card)

    # 9b: the fusion CLAPModule, 16 long and 16 short clips
    torch.cuda.reset_peak_memory_stats()
    tok = HashTokenizer(context_length=TEXT_CONTEXT)
    golden = CLAPModule(enable_fusion=True, device=dev, seed=0, tokenizer=tok)
    amp = CLAPModule(enable_fusion=True, device=dev, seed=0, tokenizer=tok,
                     compute_dtype=torch.bfloat16)
    audio_cfg = golden.model_cfg["audio_cfg"]
    clips = [(0.1 * rng.standard_normal(n)).astype(np.float32)
             for n in [FUSION_LONG] * (B // 2) + [FUSION_SHORT] * (B // 2)]
    with open(os.path.join(REPO, "class_labels", "ESC50_class_labels_indices_space.json")) as f:
        prompts = [PROMPT_TEMPLATES["default"].format(c) for c in json.load(f)]
    classifier = torch.from_numpy(golden.get_text_embedding(prompts)).to(dev)
    with torch.no_grad():
        fcfg = featurize.fusion_frontend_config(audio_cfg)
        for n in (FUSION_LONG, FUSION_SHORT):
            w = torch.from_numpy(clips[0 if n == FUSION_LONG else -1][None]).to(dev)
            got, plain = k1.fused_logmel(w, fcfg), k1.logmel_plain(w, fcfg)
            stats.check("fused_logmel", f"fusion get_mel (HTK) [1,{n}]", got, plain, "f32")
            stats.check_f64("fused_logmel", f"fusion get_mel (HTK) [1,{n}]", got, plain,
                            f64.logmel64(w, fcfg))
        launch_counts.clear()
        emb = golden.get_audio_embedding_from_data(clips)
        census_check(phase, "fusion CLAPModule golden, 32 clips", FUSION_LAUNCHES)
        launch_counts.clear()
        amp.get_audio_embedding_from_data(clips)
        census_check(phase, "fusion CLAPModule AMP, 32 clips", FUSION_LAUNCHES)
        if emb.shape != (B, 512) or not np.isfinite(emb).all():
            raise AssertionError(f"fusion embeddings malformed: {emb.shape}")
        quantized = [quantize_roundtrip(torch.from_numpy(c)).numpy() for c in clips]
        fb = golden.fusion_batch(quantized)
        longer = fb["longer"].tolist()
        log(phase, model="CLAPModule(enable_fusion=True): HTSAT-tiny aff_2d + roberta",
            clips=B, mel_fusion=list(fb["mel_fusion"].shape), longer=sum(longer))
        if longer != [True] * (B // 2) + [False] * (B // 2):
            raise AssertionError(f"fusion longer flags {longer}")
        fused = {md: encode_audio(golden.model, fb, compute_dtype=md)["normalized"]
                 for md in (None, torch.bfloat16)}
        with plain_kernels():
            ref = encode_audio(golden.model, fb)["normalized"]
        golden_check(phase, "fusion forward against the plain route", fused[None], ref)
        guard_check(phase, "fusion, 50 prompts", fused[None], fused[torch.bfloat16], classifier)
        feat_ms = host_ms(lambda: golden.fusion_batch(quantized), reps=3)
        for mode, md in (("f32", None), ("bf16", torch.bfloat16)):
            fwd = host_ms(lambda: encode_audio(golden.model, fb, compute_dtype=md))
            log(phase, model="fusion", mode=mode, featurization_ms=feat_ms, forward_ms=fwd,
                clips_per_s=1e3 * B / (feat_ms + fwd),
                forward_cuda_event_ms=time_ms(
                    lambda: encode_audio(golden.model, fb, compute_dtype=md), reps=5, warmup=1),
                card=card)
        log_profile(phase, "fusion featurization (32 clips)",
                    profile_until(lambda: golden.fusion_batch(quantized), lambda p: True,
                                  "featurization"))
        log_profile(phase, "fusion AMP forward", profile_until(
            lambda: encode_audio(golden.model, fb, compute_dtype=torch.bfloat16),
            lambda p: True, "fusion forward"))
    log(phase, stage="fusion", peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
        card=card)

    # 9c: files and folds
    with tempfile.TemporaryDirectory() as tmp:
        files = []
        for i, seconds in enumerate((3, 7, 12, 25)):
            path = os.path.join(tmp, f"clip{i}.wav")
            write_wav(path, rng.uniform(-0.5, 0.5, (44100 * seconds, 2)), 44100)
            files.append(path)
            with wave.open(path, "rb") as w:
                raw = w.readframes(w.getnframes())
            same = np.array_equal(native.pcm16_to_float32_mono(raw, 2),
                                  native.pcm16_to_float32_mono_plain(raw, 2))
            if not same:
                raise AssertionError(f"wavio.c decode of {path} differs from numpy")
        log(phase, wavio="native/wavio.c pcm16 stereo decode bit-equal to numpy", files=4,
            ok=True)
        plain_module = CLAPModule(device=dev, seed=0, tokenizer=tok)
        for label, module in (("HTSAT-tiny", plain_module), ("fusion", golden)):
            launch_counts.clear()
            t1 = time.perf_counter()
            e = module.get_audio_embedding_from_filelist(files)
            torch.cuda.synchronize()
            ok = e.shape == (4, 512) and bool(np.isfinite(e).all())
            log(phase, filelist=label, files=4, seconds="3,7,12,25",
                ms=1e3 * (time.perf_counter() - t1), launches=json.dumps(dict(launch_counts)),
                ok=ok)
            if not ok:
                raise AssertionError(f"get_audio_embedding_from_filelist ({label}) malformed")
        root = os.path.join(tmp, "esc")
        spec_audio = os.path.join(root, "data/esc50/ESC-50-master/audio")
        os.makedirs(spec_audio)
        os.makedirs(os.path.join(root, "data/esc50/ESC-50-master/meta"))
        rows = []
        for i in range(2 * FOLD_CLIPS):
            name = f"{1 + i % 2}-{100 + i}-A-{i % N_CLASSES}.wav"
            write_wav(os.path.join(spec_audio, name), rng.uniform(-0.5, 0.5, (44100 * 5, 2)),
                      44100)
            rows.append(f"{name},{1 + i % 2},{i % N_CLASSES},x,False,{100 + i},A")
        with open(os.path.join(root, "data/esc50/ESC-50-master/meta/esc50.csv"), "w") as f:
            f.write("filename,fold,target,category,esc10,src_file,take\n" + "\n".join(rows) + "\n")
        t1 = time.perf_counter()
        res = eval_zeroshot_classification.main(["--datasetpath", root, "--batch-size", "8"],
                                                device=dev, tokenizer=tok)["init"]
        log(phase, cli="eval_zeroshot_classification", clips=2 * FOLD_CLIPS,
            s=time.perf_counter() - t1,
            metrics=json.dumps({k: v for k, v in res.items() if np.isscalar(v)}))
        t1 = time.perf_counter()
        lp = lp_main.main(["--datasetpath", root, "--batch-size", "8", "--epochs", "2",
                           "--lp-lr", "1e-2", "--lp-loss", "ce", "--logs",
                           os.path.join(tmp, "logs")], device=dev)
        log(phase, cli="lp_main", folds=len(lp["per_fold"]), s=time.perf_counter() - t1,
            aggregate=json.dumps(lp["aggregate"]))
        if len(lp["per_fold"]) != 2 or not 0.0 <= lp["aggregate"]["acc"] <= 1.0:
            raise AssertionError(f"lp_main: {lp}")

    # the JAX fixtures of this slice through the port's kernels, golden
    arrays = fx.load(fx.PANN_PATH)
    for name, outs in fx.run_port_pann(arrays, dev).items():
        for key, got in outs.items():
            golden_check("fixture-towers", f"PANN {name} {key}", torch.from_numpy(got),
                         torch.from_numpy(arrays[f"out/{name}/{key}"]),
                         cos=key != "clipwise_output")
    arrays = fx.load(fx.FUSION_PATH)
    for ft, outs in fx.run_port_fusion(arrays, dev).items():
        for key, got in outs.items():
            golden_check("fixture-towers", f"fusion {ft} {key}", torch.from_numpy(got),
                         torch.from_numpy(arrays[f"out/{ft}/{key}"]),
                         cos=key != "clipwise_output")
    log(phase, phase_s=time.perf_counter() - started, card=card)


SHARD_B, SHARD_STEPS, SHARD_EPOCHS = 8, 2, 2  # 10a: batch, steps an epoch, epochs
SHARD_CLIPS = {"train": (2, 9), "valid": (1, 8)}  # shards, members a shard
MEL_CLIPS, MEL_SR = 8, 44100  # 10a: AudioProcessing.mel_spectrogram, 5 s clips
VISION_B, VISION_TIMED = 2, ("RN50", "ViT-B-32")  # 10b: every config at B=2; two at B
ZERO_SHOT_IMAGES, ZERO_SHOT_TEMPLATES = 64, 2  # 10b: of the 80 templates, to stay in time
SOT, EOT = 49406, 49407  # the CLIP BPE vocab's start and end tokens


def write_shards(root: str, rng) -> list[str]:
    """Seeded PCM16 tar shards of dataset ``clotho``: a train and a valid
    split (``SHARD_CLIPS``), 7-13 s mono clips at 48 kHz with caption JSON
    and ``sizes.json``; the second train shard's first member is truncated
    to its first 30 bytes. Returns the train shards' paths."""
    import io
    import tarfile

    def add(tf, name, data):
        info = tarfile.TarInfo(name)
        info.size = len(data)
        tf.addfile(info, io.BytesIO(data))

    train = []
    for split, (shards, members) in SHARD_CLIPS.items():
        d = os.path.join(root, "clotho", split)
        os.makedirs(d)
        for s in range(shards):
            path = os.path.join(d, f"{s:06d}.tar")
            with tarfile.open(path, "w") as tf:
                for i in range(members):
                    buf = io.BytesIO()
                    n = int(rng.integers(7 * 48000, 13 * 48000))
                    write_wav(buf, rng.uniform(-0.3, 0.3, (n, 1)), 48000)
                    data = buf.getvalue()
                    if split == "train" and s == 1 and i == 0:
                        data = data[:30]
                    add(tf, f"{split}{s}_{i:03d}.wav", data)
                    add(tf, f"{split}{s}_{i:03d}.json",
                        json.dumps({"text": f"{split} recording {s} {i} of a sound"}).encode())
            if split == "train":
                train.append(path)
        with open(os.path.join(d, "sizes.json"), "w") as f:
            json.dump({f"{s:06d}.tar": members for s in range(shards)}, f)
    return train


def phase_shards(dev, card: str, stats: KernelStats | None = None) -> None:
    """Phase 10a: the tar-shard input at full width (module docstring):
    ``training/main.py::main`` on seeded shards with the default
    ``--dataset-type`` and with ``webdataset``, ``eval_retrieval_main``,
    ``check_tars``, ``AudioProcessing.mel_spectrogram`` on K1. Any miss
    raises."""
    import shutil
    import tempfile
    import unittest.mock as mock

    import torch

    from audio_residual_tpu_torch.data.processing import AudioProcessing
    from audio_residual_tpu_torch.evaluate import eval_retrieval_main
    from audio_residual_tpu_torch.models.clap import CLAPConfig
    from audio_residual_tpu_torch.ops.cuda import KERNELS, launch_counts
    from audio_residual_tpu_torch.ops.cuda import frontend as k1
    from audio_residual_tpu_torch.training import main as train_main
    from audio_residual_tpu_torch.utils.check_tars import check_tars
    from audio_residual_tpu_torch.utils.tokenizer import HashTokenizer
    from tests import torch_f64_reference as f64
    from tests import torch_port_fixture as fx

    phase = "shards"
    stats = stats or KernelStats(KERNELS)
    started = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(43)
    tok = HashTokenizer(context_length=TEXT_CONTEXT)
    audio = CLAPConfig().audio
    train_census = {k: v for k, v in dict(fx.expected_launches(audio, train=True),
                                          **text_launches(None, train_step=True)).items() if v}
    eval_census = {k: v for k, v in dict(fx.expected_launches(audio),
                                         **text_launches(None)).items() if v}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        train_shards = write_shards(tmp, rng)
        log(phase, shards="clotho train 2 x 9 (one truncated member), valid 1 x 8",
            clips="7-13 s mono PCM16 at 48 kHz", write_s=time.perf_counter() - t0, card=card)
        real_step = train_main.make_train_step
        for label in ("auto (default)", "webdataset"):
            steps = []

            def spy(*a, **k):
                step = real_step(*a, **k)

                def timed(state, batch, gen):
                    torch.cuda.synchronize()
                    before, t1 = dict(launch_counts), time.perf_counter()
                    state, m = step(state, batch, gen)
                    loss = float(m["loss"])
                    t2 = time.perf_counter()
                    diff = {n: c - before.get(n, 0) for n, c in launch_counts.items()
                            if c - before.get(n, 0)}
                    steps.append(dict(start=t1, end=t2, loss=loss, launches=diff))
                    return state, m

                return timed

            argv = ["--datasetpath", tmp, "--datasetnames", "clotho", "--datasetinfos", "train",
                    "--batch-size", str(SHARD_B), "--epochs", str(SHARD_EPOCHS),
                    "--train-num-samples", str(SHARD_B * SHARD_STEPS), "--val-num-samples",
                    str(SHARD_B), "--precision", "fp32", "--lr", "1e-5", "--warmup", "1",
                    "--logs", os.path.join(tmp, "logs"), "--name", label.split()[0],
                    "--seed", "3", "--log-local"]
            if label == "webdataset":
                argv += ["--dataset-type", "webdataset"]
            launch_counts.clear()
            t0 = time.perf_counter()
            with mock.patch.object(train_main, "make_train_step", spy):
                out = train_main.main(argv, tokenizer=tok)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            total = dict(launch_counts)
            n_steps = SHARD_STEPS * SHARD_EPOCHS
            want_total = {k: n_steps * train_census.get(k, 0)
                          + (SHARD_EPOCHS + 1) * eval_census.get(k, 0)
                          for k in set(train_census) | set(eval_census)}
            ckpt = os.path.join(out["ckpt_dir"], f"epoch_{SHARD_EPOCHS - 1}.pt")
            losses = [s["loss"] for s in steps]
            step_ms = [1e3 * (s["end"] - s["start"]) for s in steps]
            # host time between steps: the next batch's decode and featurization
            data_ms = [1e3 * (b["start"] - a["end"]) for a, b in zip(steps, steps[1:])
                       if b is not steps[SHARD_STEPS]]
            ok = (len(steps) == n_steps and all(np.isfinite(losses))
                  and all(s["launches"] == train_census for s in steps)
                  and total == want_total and os.path.exists(ckpt)
                  and np.isfinite(out["metrics"]["all/cumulative_loss"]))
            med_step, med_data = statistics.median(step_ms), statistics.median(data_ms)
            log(phase, main=label, model="HTSAT-tiny + roberta (create_model)", batch=SHARD_B,
                steps=len(steps), losses=json.dumps(losses),
                step_launches=json.dumps(steps[0]["launches"]),
                expected_step_launches=json.dumps(train_census), run_launches=json.dumps(total),
                expected_run_launches=json.dumps(want_total), checkpoint=os.path.basename(ckpt),
                val_cumulative_loss=out["metrics"]["all/cumulative_loss"], run_s=run_s,
                step_ms=json.dumps(step_ms), median_step_ms=med_step,
                median_host_ms_between_steps=med_data,
                host_share=med_data / (med_data + med_step), ok=ok, card=card)
            if not ok:
                raise AssertionError(f"shards main {label}: a loss is not finite, the launches "
                                     "differ from the census or no checkpoint was written")

        t0 = time.perf_counter()
        res = eval_retrieval_main.main(
            ["--datasetpath", tmp, "--datasetnames", "clotho", "--split", "valid",
             "--batch-size", str(SHARD_B), "--pretrained", ckpt], tokenizer=tok)
        (m,) = res["history"]
        scores = {k: v for k, v in m.items() if "R@" in k or "mAP" in k}
        ok = len(scores) == 8 and all(np.isfinite(v) and 0.0 <= v <= 1.0
                                      for v in scores.values())
        log(phase, cli="eval_retrieval_main", clips=m["num_samples"], s=time.perf_counter() - t0,
            metrics=json.dumps(scores), best=res["best"]["metric"], ok=ok, card=card)
        if not ok:
            raise AssertionError(f"eval_retrieval_main: metrics {scores}")

        check_dir = os.path.join(tmp, "check", "train")
        shutil.copytree(os.path.dirname(train_shards[0]), check_dir)
        report = check_tars(check_dir, verbose=False)
        ok = report["bad"] == [os.path.basename(train_shards[1])] and report["ok"] == {
            os.path.basename(train_shards[0]): SHARD_CLIPS["train"][1]}
        log(phase, check_tars=json.dumps(report), ok=ok)
        if not ok:
            raise AssertionError(f"check_tars did not name the truncated shard: {report}")

    # AudioProcessing.mel_spectrogram on K1, its floor over the whole batch
    wav = torch.from_numpy((rng.standard_normal((MEL_CLIPS, 5 * MEL_SR))
                            * np.logspace(-4, 0, MEL_CLIPS)[:, None]).astype(np.float32)).to(dev)
    cfg = AudioProcessing.frontend_config()
    launch_counts.clear()
    got = AudioProcessing.mel_spectrogram(wav, device=dev)
    census_check(phase, "mel_spectrogram [8, 220500]", {"fused_logmel": 1})

    def floor(x):
        return torch.maximum(x, x.max() - 80.0)

    plain = floor(k1.logmel_plain(wav, cfg, "f32"))
    label = f"AudioProcessing.mel_spectrogram [{MEL_CLIPS},{5 * MEL_SR}] 44.1 kHz, top_db 80"
    stats.check("fused_logmel", label, got, plain, "f32")
    stats.check_f64("fused_logmel", label, got, plain, floor(f64.logmel64(wav, cfg)))
    floored = float((got == got.max() - 80.0).float().mean())
    log(phase, mel_spectrogram=label, floored_share=floored,
        cuda_event_ms=time_ms(lambda: AudioProcessing.mel_spectrogram(wav, device=dev), reps=5),
        plain_ms=time_ms(lambda: floor(k1.logmel_plain(wav, cfg, "f32")), reps=5), card=card)
    log(phase, phase_s=time.perf_counter() - started,
        peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9, card=card)


def clip_tokens(texts: list[str]):
    """CLIP-shaped token rows ``[N, 77]`` without the BPE vocab (not in the
    repository): SOT, word hashes, EOT (the row's largest id), zeros."""
    from audio_residual_tpu_torch.utils.tokenizer import HashTokenizer

    enc = HashTokenizer(vocab_size=SOT, context_length=TEXT_CONTEXT)(texts)
    ids = enc["input_ids"] * enc["attention_mask"]
    ids[:, 0] = SOT
    ids[np.arange(len(texts)), enc["attention_mask"].sum(1) - 1] = EOT
    return ids


def phase_vision(dev, card: str) -> None:
    """Phase 10b: every vision config's CLIP on the card (module docstring),
    RN50 and ViT-B-32 timed at B=32 against the CPU, the vision JAX
    fixture, ImageNet zero-shot. Any miss raises."""
    import copy

    import torch

    from audio_residual_tpu_torch.evaluate import zero_shot_imagenet as zsi
    from audio_residual_tpu_torch.models import clip
    from audio_residual_tpu_torch.models.factory import create_model, list_models
    from tests import torch_port_fixture as fx

    phase = "vision"
    started = time.perf_counter()
    rng = np.random.default_rng(47)
    names = [n for n in list_models() if n.startswith(("RN", "ViT"))]
    if len(names) != 10:
        raise AssertionError(f"vision: the registry lists {names}, not the 10 vision configs")
    tokens = torch.from_numpy(clip_tokens(["a photo of a dog", "a diagram"])).to(dev)
    kept = {}
    for name in names:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model, cfg, _ = create_model(name, "transformer", seed=0, device=dev)
        build_s = time.perf_counter() - t0
        size = cfg.vision.image_size
        images = torch.from_numpy(rng.standard_normal((VISION_B, 3, size, size)).astype(
            np.float32)).to(dev)
        with torch.no_grad():
            img, txt, scale = clip.clip_apply(model, images, tokens)
        torch.cuda.synchronize()
        norms = torch.cat([img.norm(dim=-1), txt.norm(dim=-1)])
        ok = (img.shape == txt.shape == (VISION_B, cfg.embed_dim)
              and bool(torch.isfinite(img).all() and torch.isfinite(txt).all())
              and float((norms - 1).abs().max()) < 1e-5
              and abs(float(scale) * 0.07 - 1) < 1e-6)
        log(phase, model=name, image_size=size, embed_dim=cfg.embed_dim,
            params=sum(p.numel() for p in model.parameters()), build_s=build_s,
            max_norm_err=float((norms - 1).abs().max()), logit_scale=float(scale),
            peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9, ok=ok, card=card)
        if not ok:
            raise AssertionError(f"vision {name}: features or logit scale malformed")
        if name in VISION_TIMED:
            kept[name] = model
        del model
    torch.cuda.empty_cache()

    for name, model in kept.items():
        size = model.cfg.vision.image_size
        images = torch.from_numpy(rng.standard_normal((B, 3, size, size)).astype(
            np.float32)).to(dev)
        with torch.no_grad():
            got = clip.clip_encode_image(model, images)
            ms = time_ms(lambda: clip.clip_encode_image(model, images), reps=5, warmup=1)
            cpu = copy.deepcopy(model).cpu()
            t0 = time.perf_counter()
            ref = clip.clip_encode_image(cpu, images.cpu())
            cpu_s = time.perf_counter() - t0
        rel = float((got.cpu() - ref).abs().max() / ref.abs().max())
        ok = rel <= 1e-4
        log(phase, model=name, batch=B, image_size=size, golden_cuda_event_ms=ms,
            images_per_s=1e3 * B / ms, cpu_s=cpu_s, max_rel_err_against_cpu=rel, tol=1e-4,
            ok=ok, card=card)
        if not ok:
            raise AssertionError(f"vision {name}: the card's features differ from the CPU's")
        with torch.no_grad():
            log_profile(phase, f"{name} golden B={B}", profile_until(
                lambda: clip.clip_encode_image(model, images), lambda p: True, name), card)

    model = kept["ViT-B-32"]
    classnames, templates = zsi.load_imagenet_zeroshot_data()
    size = model.cfg.vision.image_size
    images = rng.standard_normal((ZERO_SHOT_IMAGES, 3, size, size)).astype(np.float32)
    labels = rng.integers(0, len(classnames), ZERO_SHOT_IMAGES)
    batches = [(torch.from_numpy(images[i: i + B]).to(dev), labels[i: i + B])
               for i in range(0, ZERO_SHOT_IMAGES, B)]
    def encode_text(texts):
        return clip.clip_encode_text(model, torch.from_numpy(clip_tokens(texts)).to(dev))

    t0 = time.perf_counter()
    with torch.no_grad():
        res = zsi.zero_shot_eval(lambda x: clip.clip_encode_image(model, x), encode_text,
                                 {"imagenet-val": batches}, 1, classnames=classnames,
                                 templates=templates[:ZERO_SHOT_TEMPLATES])
    ok = set(res) == {"imagenet-zeroshot-val-top1", "imagenet-zeroshot-val-top5"} and all(
        0.0 <= v <= 1.0 for v in res.values())
    log(phase, zero_shot="ViT-B-32 on 64 seeded images, 1000 ImageNet classes",
        templates=f"the first {ZERO_SHOT_TEMPLATES} of {len(templates)} (time)",
        s=time.perf_counter() - t0, metrics=json.dumps(res), ok=ok, card=card)
    if not ok:
        raise AssertionError(f"zero_shot_eval: {res}")
    del kept, model
    torch.cuda.empty_cache()
    phase_fixture(fx.VISION_PATH, "fixture-vision", run=lambda a: {
        f"{name}/{key}": v for name, outs in fx.run_port_vision(a, dev).items()
        for key, v in outs.items()})
    log(phase, phase_s=time.perf_counter() - started, card=card)


FSDP_STEPS = 2  # steps of each run, from one state
# (label, sharded, remat): the step without FSDP, and with it without and with
# the recomputed forward
FSDP_RUNS = (("plain", False, False), ("fsdp", True, False), ("fsdp_remat", True, True))
FSDP_TOL = dict(atol=2e-5, rtol=1e-4)  # golden parameters (tests/test_torch_distributed.py)
FSDP_LOSS_RTOL = {"f32": 1e-5, "bf16": TOL["bf16"]}
# one step of each run in turn, the order reversed every other round, after
# one untimed step each: the runs' step ms and the paired differences
FSDP_TIMING_ROUNDS = 10
# measure_seconds against time_ms on one forward: trials, each time_ms of 5
# calls in a row (what measure_seconds times, at one length) then
# measure_seconds; their medians' ratio at most this
TIMING_TRIALS, TIMING_AGREEMENT = 5, 1.1


def fsdp_step_times(runs: dict, batch: dict, mode: str, card: str) -> None:
    """Phase 11's step ms: :data:`FSDP_TIMING_ROUNDS` rounds of one
    CUDA-event-timed step of each run (``runs[label]["live"]``, its state
    and step), alternating, so that the card's and the host's drift falls
    on every run alike; each run's median into ``runs[label]["step_ms"]``,
    and each FSDP run's per-round difference from the step without FSDP
    logged in full, the negative ones too. Frees the runs' states."""
    import torch

    labels = [label for label, _, _ in FSDP_RUNS]

    def one(label):
        state, step = runs[label]["live"]
        return time_ms(lambda: step(state, batch, torch.Generator().manual_seed(3)),
                       reps=1, warmup=0)

    for label in labels:
        one(label)
    times = {label: [] for label in labels}
    for r in range(FSDP_TIMING_ROUNDS):
        for label in (labels if r % 2 == 0 else labels[::-1]):
            times[label].append(one(label))
    for label in labels:
        runs[label]["step_ms"] = statistics.median(times[label])
        runs[label].pop("live")
        extra = {}
        if label != "plain":
            d = [a - b for a, b in zip(times[label], times["plain"])]
            extra = dict(minus_plain_ms_median=statistics.median(d), minus_plain_ms_min=min(d),
                         minus_plain_ms_max=max(d),
                         rounds_slower_than_plain=sum(x > 0 for x in d))
        log("fsdp", step_times=label, mode=mode, rounds=FSDP_TIMING_ROUNDS,
            step_ms_median=runs[label]["step_ms"], step_ms_min=min(times[label]),
            step_ms_max=max(times[label]), step_ms_each=json.dumps(times[label]), **extra,
            card=card)


def tower_cosines(a: dict, b: dict, init: dict, names) -> dict:
    """Per tower, the cosine between two runs' updates of the parameters
    ``names`` (state after minus ``init``)."""
    ua = {n: a[n].double() - init[n].double() for n in names}
    ub = {n: b[n].double() - init[n].double() for n in names}
    return {tower: _cosine(ua, ub, [n for n in names if tower_of(n) == tower])
            for tower in ("audio", "text", "logit_scales")}


def freeze_text_check(model, state, batch, md, mesh) -> tuple[dict, dict]:
    """A sharded model's checkpoint (its unsharded state dict, returned),
    one ``freeze_text`` step with a fresh AdamW without decay, a second
    checkpoint, and ``check_ckpt_diff`` between the two: every parameter the
    step's gradient reached must move, every text parameter stay."""
    import tempfile

    import torch
    from torch.distributed.tensor import DTensor

    from audio_residual_tpu_torch.training import checkpoints
    from audio_residual_tpu_torch.training import train_clap as tc
    from audio_residual_tpu_torch.utils.check_ckpt import check_ckpt_diff

    with tempfile.TemporaryDirectory() as tmp:
        before = checkpoints.save_checkpoint(tmp, state, 0, "fsdp")
        sd = torch.load(before, map_location="cpu", weights_only=True)["state_dict"]
        optimizer = tc.make_optimizer(model, **{**CONTRASTIVE_OPT, "weight_decay": 0.0})
        step = tc.make_train_step(model, optimizer, compute_dtype=md, freeze_text=True,
                                  fsdp_mesh=mesh)
        step(tc.init_train_state(model, optimizer), batch, torch.Generator().manual_seed(2))
        reached = [n for n, p in model.named_parameters() if float(
            (p.grad.full_tensor() if isinstance(p.grad, DTensor) else p.grad).abs().max()) > 0]
        after = checkpoints.save_checkpoint(tmp, {"model": model, "optimizer": optimizer,
                                                  "step": 1}, 1, "fsdp")
        diffs = check_ckpt_diff(before, after, verbose=False)
    text = [n for n, _ in model.named_parameters() if tc.is_text_param(n)]
    moved = [n for n in reached if diffs[n] > 0]
    still = [n for n in text if diffs[n] == 0]
    ok = bool(reached) and len(moved) == len(reached) and len(still) == len(text) and bool(text)
    return sd, dict(keys=len(diffs), reached=len(reached), moved=len(moved), text=len(text),
                    text_unchanged=len(still), ok=ok)


@contextlib.contextmanager
def gc_pauses():
    """The Python garbage collector's passes during the block: a list,
    filled as they end, of ``[generation, ms]``."""
    import gc

    seen, start = [], []

    def note(phase, info):
        if phase == "start":
            start[:] = [time.perf_counter()]
        elif start:
            seen.append([info["generation"], (time.perf_counter() - start[0]) * 1e3])

    gc.callbacks.append(note)
    try:
        yield seen
    finally:
        gc.callbacks.remove(note)


def sm_clock() -> str:
    """The card's SM clock and power draw now, as ``nvidia-smi`` reads
    them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()


def phase_fsdp(dev, card: str) -> None:
    """Phase 11: FSDP on the card (module docstring). Phase 8's model and
    batch through ``make_train_step(fsdp_mesh=...)`` over a one-rank NCCL
    group against the step without FSDP, golden and AMP; the dry run's
    stages 1, 2 and 2b in a process of their own; the utilities. Any miss
    raises."""
    import copy
    import inspect

    import torch
    import torch.distributed as dist
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import DTensor

    from audio_residual_tpu_torch.dryrun import dryrun_multichip
    from audio_residual_tpu_torch.module import CLAPModule
    from audio_residual_tpu_torch.ops.cuda import launch_counts
    from audio_residual_tpu_torch.parallel import fsdp
    from audio_residual_tpu_torch.training import train_clap as tc
    from audio_residual_tpu_torch.utils.profiling import measure_seconds
    from audio_residual_tpu_torch.utils.tokenizer import HashTokenizer
    from tests import torch_port_fixture as fx

    phase = "fsdp"
    started = time.perf_counter()
    keywords = {k: k in inspect.signature(fully_shard).parameters
                for k in ("shard_placement_fn", "ignored_params")}
    log(phase, torch=torch.__version__, cuda=torch.version.cuda,
        fully_shard_keywords=json.dumps(keywords), card=card)
    if not all(keywords.values()):
        raise AssertionError(f"fsdp: this torch's fully_shard lacks {keywords}")
    tok = HashTokenizer(context_length=TEXT_CONTEXT)
    base = CLAPModule(device=dev, seed=0, tokenizer=tok)
    cfg = base.cfg
    init = {k: v.detach().clone() for k, v in base.model.state_dict().items()}
    batch = contrastive_batch(tok, dev)
    mesh = fsdp.fsdp_mesh(dev)
    try:
        for mode, md in (("f32", None), ("bf16", torch.bfloat16)):
            want_census = {k: v for k, v in fx.expected_launches(cfg.audio, train=True).items()
                           if v}
            runs = {}
            for label, sharded, remat in FSDP_RUNS:
                # the run's own peak: above what was resident before its
                # model, the earlier runs of this mode (kept for the timing
                # rounds) too
                torch.cuda.synchronize()
                resident = torch.cuda.memory_allocated()
                model = copy.deepcopy(base.model)
                model.load_state_dict(init)
                kw = {}
                if sharded:
                    fsdp.shard_model(model, mesh)
                    kw["fsdp_mesh"] = mesh
                optimizer = tc.make_optimizer(model, **CONTRASTIVE_OPT)
                state = tc.init_train_state(model, optimizer)
                step = tc.make_train_step(model, optimizer, compute_dtype=md, remat=remat, **kw)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                losses, norms, census, frozen = [], [], [], None
                for i in range(FSDP_STEPS):
                    launch_counts.clear()
                    state, m = step(state, batch, torch.Generator().manual_seed(i))
                    census.append(dict(launch_counts))
                    losses.append(float(m["loss"]))
                    norms.append(float(m["grad_norm"]))
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated() - resident
                if label == "fsdp":
                    # the unsharded file a run without FSDP writes; then one
                    # step with the text side frozen (--freeze-text), checked
                    # on the two checkpoints
                    sd, frozen = freeze_text_check(model, state, batch, md, mesh)
                else:
                    sd = {k: v.detach().to("cpu", copy=True) for k, v in (
                        fsdp.full_state_dict(model)[0] if sharded else model.state_dict()
                    ).items()}
                runs[label] = dict(losses=losses, norms=norms, sd=sd, frozen=frozen, peak=peak,
                                   params=[n for n, _ in model.named_parameters()],
                                   sharded=sum(isinstance(p, DTensor)
                                               for p in model.parameters()),
                                   live=(state, step))
                # the recomputed forward launches the kernels again in the backward;
                # FSDP gathers whole weights around the forward and the backward,
                # so the text tower takes the same route sharded or not
                want = dict({k: v * (2 if remat else 1) for k, v in want_census.items()},
                            **text_launches(md, train_step=True, remat=remat))
                ok = all(c == want for c in census)
                log(phase, run=label, mode=mode, steps=FSDP_STEPS, losses=json.dumps(losses),
                    grad_norms=json.dumps(norms), launches=json.dumps(census),
                    expected_each_step=json.dumps(want), census_ok=ok,
                    sharded_params=runs[label]["sharded"],
                    own_peak_allocated_gb=peak / 1e9, card=card)
                if not ok:
                    raise AssertionError(f"fsdp {mode} {label}: a step launched {census}, "
                                         f"phase 8's census gives {want}")
                del state, optimizer, step, model
            fsdp_step_times(runs, batch, mode, card)
            torch.cuda.empty_cache()
            plain = runs["plain"]
            names = plain["params"]
            for label in ("fsdp", "fsdp_remat"):
                run = runs[label]
                loss_ok = bool(np.allclose(run["losses"], plain["losses"],
                                           rtol=FSDP_LOSS_RTOL[mode], atol=0))
                if md is None:
                    bad = [n for n in plain["sd"] if not np.allclose(
                        run["sd"][n].numpy(), plain["sd"][n].numpy(), **FSDP_TOL)]
                    worst = max(names, key=lambda n: float(
                        (run["sd"][n] - plain["sd"][n]).abs().max()))
                    limit = f"atol={FSDP_TOL['atol']},rtol={FSDP_TOL['rtol']}"
                    detail = {"worst_param": worst, "worst_max_abs_diff": float(
                        (run["sd"][worst] - plain["sd"][worst]).abs().max())}
                else:
                    cos = tower_cosines(run["sd"], plain["sd"],
                                        {n: init[n].cpu() for n in names}, names)
                    bad = [t for t, c in cos.items() if c < GRAD_COS]
                    limit = f"update cosine a tower >= {GRAD_COS}"
                    detail = {"worst_tower": min(cos, key=cos.get),
                              "update_cosines": json.dumps(cos)}
                ok = (loss_ok and not bad and set(run["sd"]) == set(plain["sd"])
                      and run["sharded"] > 0)
                log(phase, check=f"{label} against plain, {mode}", losses_ok=loss_ok,
                    loss_rtol=FSDP_LOSS_RTOL[mode],
                    max_loss_rel_diff=max(abs(a - b) / abs(b) for a, b in
                                          zip(run["losses"], plain["losses"])),
                    params=len(names), params_limit=limit, params_out_of_bounds=len(bad),
                    **detail, step_ms_plain=plain["step_ms"], step_ms=run["step_ms"],
                    peak_gb_plain=plain["peak"] / 1e9, peak_gb=run["peak"] / 1e9, ok=ok,
                    card=card)
                if not ok:
                    raise AssertionError(f"fsdp {mode}: the {label} step differs from the step "
                                         f"without FSDP (out of bounds: {bad[:5]})")
            log(phase, check_ckpt_diff=f"before -> after a --freeze-text step, {mode}",
                **runs["fsdp"]["frozen"])
            if not runs["fsdp"]["frozen"]["ok"]:
                raise AssertionError(f"fsdp {mode}: check_ckpt_diff found a trained weight that "
                                     "did not move or a frozen one that did")
    finally:
        dist.destroy_process_group()

    # measure_seconds against time_ms on one zero-shot forward, in trials,
    # with the card's clock and the device time of a forward beside them
    with torch.no_grad():
        args = (batch["waveform"], batch["input_ids"], batch["attention_mask"])

        def forward(w, i, a):
            return base.model({"waveform": w}, i, a)

        busy = device_busy_ms(lambda: forward(*args))
        in_a_row, by_two_lengths = [], []
        for trial in range(TIMING_TRIALS):
            clock = sm_clock()
            in_a_row.append(time_ms(lambda: [forward(*args) for _ in range(5)],
                                    reps=3, warmup=1) / 5)
            attempts = []
            with gc_pauses() as pauses:
                by_two_lengths.append(measure_seconds(forward, args, iters=5,
                                                      record=attempts) * 1e3)
            log(phase, timing_trial=trial, time_ms_5_in_a_row=in_a_row[-1],
                measure_seconds_ms=by_two_lengths[-1], ratio=by_two_lengths[-1] / in_a_row[-1],
                attempts=json.dumps(attempts), gc_passes=json.dumps(pauses),
                sm_clock_before=clock, sm_clock_after=sm_clock(), card=card)
    ratio = statistics.median(by_two_lengths) / statistics.median(in_a_row)
    ok = 1 / TIMING_AGREEMENT <= ratio <= TIMING_AGREEMENT
    log(phase, timing="clap forward, f32, B=32", trials=TIMING_TRIALS,
        time_ms_5_in_a_row_median=statistics.median(in_a_row),
        measure_seconds_ms_median=statistics.median(by_two_lengths), ratio=ratio,
        ratio_each=json.dumps([b / a for a, b in zip(in_a_row, by_two_lengths)]),
        device_busy_ms=busy, limit=TIMING_AGREEMENT, ok=ok, card=card)
    if not ok:
        raise AssertionError("fsdp: measure_seconds and time_ms disagree on one forward")
    del base
    torch.cuda.empty_cache()

    # the dry run: one process a card, its stage records as it prints them
    n = torch.cuda.device_count()
    summary = dryrun_multichip(n, stages=("1", "2", "2b"), timeout_s=600)
    log(phase, dryrun=json.dumps(summary), phase_s=time.perf_counter() - started, card=card)


WORKFLOW_KERNELS = ("fused_logmel", "fused_window_attention", "fused_residual_ffn",
                    "fused_swin_block")  # K1-K4: each launched by phase 12's workflow, K5 never
ESC50_A_CLASS = 2  # 12c's tree: clips a class (50 classes, 5 folds)
ESC50_CLIP = 240000  # 5 s at 48 kHz: no resample on the host
PERF_BATCH = B  # 12d: perf_breakdown's batch


def workflow_stage(stages: dict, name: str, fn):
    """``fn`` wrapped to add, to ``stages[name]``, its seconds (synchronised),
    the launches its wrappers counted and the port's kernels a
    ``torch.profiler`` window (CUDA activity) saw, by CUDA kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from audio_residual_tpu_torch.ops.cuda import launch_counts
    from audio_residual_tpu_torch.utils.profiling import device_events

    def spy(*args, **kwargs):
        torch.cuda.synchronize()
        before = collections.Counter(launch_counts)
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        kernels = collections.Counter(e.name for e in device_events(prof))
        rec = stages.setdefault(name, {"calls": 0, "s": 0.0, "launches": collections.Counter(),
                                       "census": collections.Counter()})
        rec["calls"] += 1
        rec["s"] += seconds
        rec["launches"].update(collections.Counter(launch_counts) - before)
        rec["census"].update(port_kernels(kernels))
        return out

    return spy


def write_esc50_tree(root: str, rng) -> int:
    """ESC-50's own layout (``DATASETS["ESC50"]``: ``esc50.csv`` and the audio
    directory), all 50 classes, ``ESC50_A_CLASS`` seeded 5 s clips a class
    at 48 kHz (PCM16 mono: a tone a class in noise) over the 5 folds."""
    from audio_residual_tpu_torch.data.datasets import DATASETS

    spec = DATASETS["ESC50"]
    audio = os.path.join(root, spec["audio_dir"])
    os.makedirs(audio)
    os.makedirs(os.path.dirname(os.path.join(root, spec["csv_path"])))
    t = np.arange(ESC50_CLIP) / 48000
    rows = []
    for c in range(N_CLASSES):
        for k in range(ESC50_A_CLASS):
            fold = 1 + (ESC50_A_CLASS * c + k) % 5
            name = f"{fold}-{1000 * c + k}-A-{c}.wav"
            x = 0.3 * np.sin(2 * np.pi * (100 + 60 * c) * t) + 0.05 * rng.standard_normal(t.size)
            write_wav(os.path.join(audio, name), x[:, None], 48000)
            rows.append(f"{name},{fold},{c},{spec['class_labels'][c]},False,{1000 * c + k},A")
    with open(os.path.join(root, spec["csv_path"]), "w") as f:
        f.write("filename,fold,target,category,esc10,src_file,take\n" + "\n".join(rows) + "\n")
    return len(rows)


def phase_experiments(dev, card: str) -> None:
    """Phase 12: the paper's experiment drivers (``audio_residual_tpu_torch/
    examples/``) on the card, golden f32. (a) ``full_workflow --size full``
    at its defaults; (b) its baseline eval of fold 0, one λ epoch and λ's
    gradient through the kernels against the plain versions; (c) drivers 1-3 on a
    seeded ESC-50 tree through ``CLAPModule()``; (d) ``perf_breakdown`` at
    B = 32."""
    import tempfile
    from unittest import mock

    import torch

    from audio_residual_tpu_torch.evaluate import harness
    from audio_residual_tpu_torch.examples import (analyze_clap_attention,
                                                   apply_residual_to_clap,
                                                   evaluate_and_compare, full_workflow,
                                                   perf_breakdown)
    from audio_residual_tpu_torch.ops.cuda import build, launch_counts
    from audio_residual_tpu_torch.residual import analyze
    from audio_residual_tpu_torch.residual.module import load_residual_params
    from audio_residual_tpu_torch.training import linear_probe, train_residual

    phase, started = "experiments", time.perf_counter()
    # the drivers call enable_compile_cache(): keep the kernels built in phase 1
    with mock.patch.dict(os.environ, {"ART_COMPILE_CACHE": str(build.BUILD_DIR),
                                      "BENCH_BATCH": str(PERF_BATCH)}):
        with tempfile.TemporaryDirectory() as tmp:
            # (a) the whole experiment at full width
            t0 = time.perf_counter()
            model, cfg, _ = full_workflow.build_model("full", 0, None, dev)
            log(phase, workflow="build_model full", model="HTSAT-tiny + RoBERTa-base",
                s=time.perf_counter() - t0)
            stages: dict = {}
            spies = [(full_workflow, "anchored_text_embeds", "anchors"),
                     (analyze, "compute_pca_components", "pca"),
                     (train_residual, "train_and_evaluate_residual", "residual"),
                     (train_residual, "evaluate_baseline_clap", "baseline"),
                     (linear_probe, "train_and_eval_linear_head", "linear"),
                     (harness, "visualize_eval_metrics", "harness"),
                     (harness, "compare_variants", "harness")]
            out_dir = os.path.join(tmp, "workflow")
            with contextlib.ExitStack() as stack:
                for mod, fn_name, stage in spies:
                    stack.enter_context(mock.patch.object(
                        mod, fn_name, workflow_stage(stages, stage, getattr(mod, fn_name))))
                launch_counts.clear()
                t0 = time.perf_counter()
                summary = full_workflow.main(["--size", "full", "--out-dir", out_dir],
                                             model=model)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                total = collections.Counter(launch_counts)
            if sum((rec["launches"] for rec in stages.values()), collections.Counter()) != total:
                raise AssertionError(f"{phase}: launches outside the workflow's stages: {total}")
            for stage, rec in stages.items():
                log(phase, stage=stage, calls=rec["calls"], s=rec["s"],
                    launches=json.dumps(dict(rec["launches"])),
                    census=json.dumps(dict(rec["census"])), card=card)
            log(phase, workflow="main", s=wall, launches=json.dumps(dict(total)),
                summary=json.dumps(summary), card=card)
            for check, ok in summary["checks"].items():
                log(phase, learning_check=check, value=ok)
            layer = summary["inject_layers"][0]
            want_files = sorted([f"lambda_layer{layer}_evalfold_{i}.pkl" for i in range(2)]
                                + [f"layers_{layer}_evalfold_{i}.npz" for i in range(2)])
            problems = [k for k in WORKFLOW_KERNELS if not total[k]]
            if total["wide_window_attention"]:
                problems.append("wide_window_attention launched")
            if not (summary["lambda_moved"] and summary["checks"]["loss_finite"]):
                problems.append("λ did not move or the loss is not finite")
            if summary["artifacts"]["npz"] != want_files:
                problems.append(f"artifacts {summary['artifacts']['npz']}")
            log(phase, structural="lambda_moved, loss_finite, 2 npz + 2 pkl, K1-K4 launched, "
                "no K5", ok=not problems)
            if problems:
                raise AssertionError(f"{phase} workflow: {problems}")

            # (b) the baseline eval of fold 0 and one λ epoch: kernels against
            # the plain versions, the same weights
            max_len = cfg.audio.clip_samples
            folds, templates = full_workflow.synth_folds(5, 2, 32, max_len // 2, 0)
            text = full_workflow.anchored_text_embeds(model, templates, max_len, wav_noise=0.05,
                                                      anchor_noise=1.2, seed=0)
            pca_path = os.path.join(out_dir, "pca", "SYNTH", f"layer_{layer}_evalfold_0")
            residual = {layer: load_residual_params(pca_path, device=dev)}
            runs = {}
            for route in ("kernels", "plain"):
                with plain_kernels() if route == "plain" else contextlib.nullcontext():
                    launch_counts.clear()
                    preds, targets, sims = train_residual.evaluate_zero_shot(
                        model, folds[0][1](), text, max_len=max_len)
                    trained, hist = train_residual.train_residual(
                        model, folds[0][0], text, residual, epochs=1, lr=0.05, max_len=max_len)
                    # λ's gradient on fold 0's first batch, as the epoch's
                    # step takes it: tokens cached below the injected layer
                    lam, frozen = train_residual._split_residual(residual)
                    _, loss_fn = train_residual.make_zero_shot_step(
                        model, text, frozen, train_residual.adam(lam, 0.05), max_len=max_len,
                        start_layer=layer, tokens_input=True)
                    tokens, y = train_residual.cache_prefix_tokens(
                        model, folds[0][0](), layer, max_len=max_len)[0]
                    loss, _ = loss_fn(lam, tokens, y)
                    (grad,) = torch.autograd.grad(loss, [lam[layer]])
                    torch.cuda.synchronize()
                    runs[route] = (preds, sims, trained[layer]["lam"], hist, dict(launch_counts),
                                   loss.detach(), grad)
            (pk, sk, lk, hk, ck, fk, gk), (pp, sp, lp_, hp, cp, fp, gp) = (runs["kernels"],
                                                                          runs["plain"])
            top2 = np.sort(sp, axis=-1)[:, -2:]
            log(phase, check="baseline fold 0 predictions, kernels against plain",
                equal=bool((pk == pp).all()), min_top2_margin=float((top2[:, 1] - top2[:, 0]).min()),
                launches_kernels=json.dumps(ck), launches_plain=json.dumps(cp))
            if not (pk == pp).all() or cp:
                raise AssertionError(f"{phase}: baseline predictions differ from the plain "
                                     f"route's, or the plain route launched {cp}")
            golden_check(phase, "baseline fold 0 similarities, kernels against plain",
                         torch.from_numpy(sk), torch.from_numpy(sp), cos=False)
            golden_check(phase, "λ-step loss, kernels against plain", fk[None], fp[None],
                         cos=False)
            rel = float((gk - gp).abs().max() / gp.abs().max())
            ok = bool(torch.isfinite(gk).all()) and rel <= GRAD_REL
            log(phase, check="λ-gradient of fold 0's first batch, kernels against plain",
                grad_max_abs=float(gp.abs().max()), max_rel_err=rel,
                limit=f"max_rel_err<={GRAD_REL}", ok=ok)
            if not ok:
                raise AssertionError(f"{phase}: the λ-gradient disagrees with the plain "
                                     f"versions' (max_rel_err {rel})")
            # Adam's first step moves each λ by about lr·sign(g): this check
            # sees the gradient's signs, the one above its size
            log(phase, check="one λ epoch, kernels against plain", loss_kernels=hk[0]["train_loss"],
                loss_plain=hp[0]["train_loss"], lam_sign_flips=int(((lk - 1) * (lp_ - 1) < 0).sum()))
            golden_check(phase, "λ after one epoch, kernels against plain", lk[None], lp_[None],
                         cos=False)

            # (c) the notebook drivers on a seeded ESC-50 tree, CLAPModule()
            t0 = time.perf_counter()
            root = os.path.join(tmp, "esc50")
            clips = write_esc50_tree(root, np.random.default_rng(12))
            log(phase, esc50_tree=clips, folds=5, classes=N_CLASSES, clip_samples=ESC50_CLIP,
                sr=48000, write_s=time.perf_counter() - t0)
            drivers = [
                (analyze_clap_attention, ["--root", root, "--max-batches", "2",
                                          "--save-dir", os.path.join(tmp, "pca_results")]),
                (apply_residual_to_clap, ["--root", root, "--layers", "0", "--epochs", "2",
                                          "--pca-path", os.path.join(tmp, "residual_pca")]),
                (evaluate_and_compare, ["--root", root, "--epochs", "2", "--pca-path",
                                        os.path.join(tmp, "residual_pca"), "--save-dir",
                                        os.path.join(tmp, "eval")]),
            ]
            for driver, argv in drivers:
                launch_counts.clear()
                t0 = time.perf_counter()
                driver.main(argv)
                torch.cuda.synchronize()
                log(phase, driver=driver.__name__.rsplit(".", 1)[1], argv=" ".join(argv[2:]),
                    s=time.perf_counter() - t0, launches=json.dumps(dict(launch_counts)),
                    card=card)
            want = ([os.path.join("pca_results", "ESC50-fold0.csv")]
                    + [os.path.join("residual_pca", "ESC50", f"layer_0_evalfold_{i}")
                       for i in range(5)]
                    + [os.path.join("eval", "ESC50", v, f"{p}evalfold_{i}.npz")
                       for v, p in (("Baseline", ""), ("ResiDual", "layers_0_"), ("Linear", ""))
                       for i in range(5)]
                    + [os.path.join("eval", "ESC50_table.json")])
            missing = [f for f in want if not os.path.isfile(os.path.join(tmp, f))]
            with open(os.path.join(tmp, "eval", "ESC50_table.json")) as f:
                table = json.load(f)
            log(phase, driver_files=len(want), missing=json.dumps(missing),
                table=json.dumps({k: {m: v[m] for m in ("accuracy_mean", "folds") if m in v}
                                  for k, v in table.items()}), ok=not missing)
            if missing or set(table) != {"Baseline", "ResiDual", "Linear"}:
                raise AssertionError(f"{phase}: the drivers did not write {missing} or the "
                                     f"table's variants {sorted(table)}")

        # (d) the per-stage breakdown
        t0 = time.perf_counter()
        line = perf_breakdown.main([], device=dev)
        log(phase, perf_breakdown=json.dumps(line), s=time.perf_counter() - t0, card=card)
    log(phase, phase_s=time.perf_counter() - started, card=card)


def phase_fixture(path, phase: str, expected: dict | None = None, run=None) -> None:
    """A JAX golden fixture through the port's kernels, golden f32;
    ``expected``: launches the run must include. ``run(arrays)`` -> ``{key:
    output}`` against ``out/<key>`` (the audio fixtures' ``run_port`` by
    default)."""
    from audio_residual_tpu_torch.ops.cuda import launch_counts
    from tests import torch_port_fixture as fx

    arrays = fx.load(path)
    launch_counts.clear()
    got = (run or (lambda a: fx.run_port(a, "cuda")))(arrays)
    for name, n in (expected or {}).items():
        if launch_counts[name] != n:
            raise AssertionError(f"{phase}: {name} launched {launch_counts[name]} times, "
                                 f"expected {n}")
    for key in (list(got) if run else fx.output_keys(arrays)):
        ref = arrays[f"out/{key}"]
        err = float(np.abs(got[key] - ref).max())
        ok = bool(np.allclose(got[key], ref, atol=2e-3, rtol=1e-3))
        if key in ("embedding", "normalized"):
            cos = (got[key] * ref).sum(-1) / (np.linalg.norm(got[key], axis=-1)
                                              * np.linalg.norm(ref, axis=-1))
            ok = ok and float(cos.min()) > 0.99999
        log(phase, output=key, max_abs_err=err, tol="atol=2e-3,rtol=1e-3", ok=ok)
        if not ok:
            raise AssertionError(f"{phase} {key} disagrees with the JAX package")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        from audio_residual_tpu_torch.ops.cuda import KERNELS, build
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    built = build.build_all()
    log("build", seconds=time.perf_counter() - t0, per_source=json.dumps(built),
        torch=torch.__version__, cuda=torch.version.cuda, card=card)

    from audio_residual_tpu_torch.models.clap import CLAPConfig, build_clap_audio
    from audio_residual_tpu_torch.models.factory import create_audio_model
    from tests import torch_port_fixture as fx

    def tiny():
        cfg = CLAPConfig()
        return build_clap_audio(cfg, seed=0, device=dev), cfg

    def base():
        model, cfg, _ = create_audio_model("HTSAT-base", seed=0, device=dev)
        return model, cfg

    stats = KernelStats(KERNELS)
    launches = collections.Counter()
    with torch.no_grad():
        phase_kernels(stats, dev)
        launches["linear_tf32x3"] = phase_linear(dev, card, stats)
        stats.log_golden()
        phase_gemm(dev)
        launches.update(phase_main(dev, card, "HTSAT-tiny (CLAPConfig defaults)", tiny,
                                   EXPECTED_LAUNCHES, EXPECTED_GOLDEN_TF32X3["tiny"]))
        launches.update(phase_main(dev, card, "HTSAT-base (create_audio_model)", base,
                                   EXPECTED_BASE_LAUNCHES, EXPECTED_GOLDEN_TF32X3["base"]))
    phase_fixture(fx.PATH, "fixture")
    phase_fixture(fx.WIDE_PATH, "fixture-wide", {"wide_window_attention": 2})
    phase_train(dev, card)
    phase_analysis(stats, dev, card)
    launches["householder_qr"] = phase_qr(stats, dev, card)
    phase_clap(dev, card)
    phase_contrastive(dev, card)
    phase_towers(dev, card, stats)
    phase_shards(dev, card, stats)
    phase_vision(dev, card)
    phase_fsdp(dev, card)
    phase_experiments(dev, card)

    print(stats.json_line(launches), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
