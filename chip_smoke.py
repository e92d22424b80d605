"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (non-zero exit):

1. device: a CUDA device is required; prints the card's name and power
   limit as nvidia-smi reports them;
2. build: compiles the port's kernels (``openpifpaf_tpu_torch/csrc/*.cu``:
   CifHr, depthwise conv with the lab's VALID mode, fused block with the
   lab's branch2 mode, the lab's interleave) from the sources next to this
   script, one nvcc per source, all started together;
3. CifHr kernel vs plain: ``cifhr_cuda.accumulate`` against its plain
   PyTorch version, bit for bit, on seeded random cells at the decode's
   shapes (F, K) = (17, 256), (17, 1024), (133, 256), (133, 1024) and on
   the golden file's sparse and crowd cells at both tiers' budgets: each
   call's launch
   plan, one device op per call (``torch.profiler``), the call time (CUDA
   events), the device time alone, with a cold L2 (96 MB written between
   calls) and the card's write floor (``zero_`` of the map);
4. backbone kernels vs plain: ``dw_cuda.depthwise_conv``,
   ``shuffle_cuda.fused_block`` and ``block_cuda.branch2_apply`` against
   their plain versions at the three stage shapes of shufflenetv2k16 for
   one 513x641 image, plus a dilated leaky case, in float32 and bfloat16
   with TF32 off: each call's launch plan, the per-call times (CUDA
   events), the kernel's device time alone and the library call's (cuDNN,
   all its device ops) from ``torch.profiler``, and at stage 2 the
   kernel's device time with a cold L2 (96 MB written between calls);
5. golden decode: ``CifCaf.batch_decode`` on the fields of
   ``tests/golden/torch_decode_golden.npz`` (written with the JAX package)
   must give the stored JAX poses within the tie-free parity gate, go
   through the kernel and escalate the 40-person scene to the crowd tier;
   then each scene's warm batch-1 decode time;
5b. decoder configurations: the golden scenes decoded under every run of
   ``torch_port_helpers.golden_runs`` (each CifHr impl, greedy,
   block_joints, force-complete with and without the NMS before it, the
   decoding order, initial poses, each ablation, ``CifCafDense``; the
   40-person scene lazy and with force-complete through the crowd tier),
   each built from the decoder's CLI flags: the stored JAX poses within
   the gate, equal decoding orders and ids, the CifHr kernel's launches
   (some under 'auto' and 'pallas', none under 'lazy', 'dense' and the
   CifHr skip), and the warm batch-1 decode time, device ops and stream
   syncs per decode (``torch.profiler``);
6. main path: a full-width shufflenetv2k16 cocokp ``Predictor`` (random
   weights from seed 0) answers three single-image requests and one batch
   of two 481x641 images, then one request each with
   ``--force-complete-pose`` and ``--greedy`` (flags parsed by the predict
   CLI), with field shapes and values checked, and the CifHr kernel's
   launch count read around that run; each request's end-to-end, NN and
   decode time per image;
7. backbone engines: the same model served with ``backbone_engine``
   ``'dwpallas'``, ``'pallas'`` and ``'folded'`` on the same requests: each
   engine's fields equal the module graph's (TF32 off), its kernel
   launches 13 times per forward (k16's non-first blocks), and each
   request's times are printed; a bfloat16 ``'pallas'`` request gives finite
   fields close to the float32 ones;
8. branch2 path: ``block_cuda.build_mosaic_forward`` on the folded k16
   backbone gives the module graph's features with 13 branch2 launches;
9. forward profile: each engine's batch-1 NN time (CUDA events) and, from
   ``torch.profiler``, its device time, device ops and BatchNorm kernels;
10. lab: the Mosaic lab's kernels (``lab.kernels.lane_interleave``;
    ``dw_valid`` and ``branch2``, the VALID and lab modes of the depthwise
    and fused-block kernels) against their plain versions at the lab's
    three stage shapes in float32 and bfloat16 with TF32 off: each call's
    launch plan, kernel, plain and library times (CUDA events), the
    kernel's device time alone and the library call's (``torch.profiler``);
    then the lab's entry point ``lab.mosaic_lab.main(['interleave', 'dw',
    'branch2'])`` runs once with every launch count read around it (a lab
    run moves the lab's counters only);
11. training: a synthetic COCO keypoint set (80 JPEG images of 427x569
    with 1-4 people, ``torch_port_helpers.write_synthetic_coco``, seed 0)
    in a temporary directory, then (a) one train step of the full-width
    k16 with the cocokp heads on the first image of a batch of 8 at
    385 px of the port's
    CocoKp pipeline on the card (TF32 off) against the same step on the
    CPU in float64 (the CPU's float32 step measures float32's own error):
    losses, parameters, BatchNorm buffers and EMA compared; (b)
    ``train.main`` in-process for 4 steps and 1 validation batch in
    float32, ``--bf16`` and ``--remat``: checkpoints and finite losses,
    the warm step time (CUDA events), images per second, peak memory and
    the loader's share of the loop's wall time; (c) the float32 run's
    checkpoint served by ``Predictor(checkpoint=...)`` on the card (the
    trainer's EMA weights, one request with its fields checked, CifHr
    launches read around it), then one more float32 step on (a)'s batch
    with its CUDA-event time, peak memory and, from ``torch.profiler``,
    device ops, stream syncs and device busy ms; (d) 40 steps on one fixed batch: the loss
    must fall. The training path runs no hand-written kernel (the step
    is cuDNN through autograd);
12. other backbones and eval: (a) every ``BASE_FACTORIES`` entry at full
    width, and a group-norm and an instance-norm k16, one float32 forward
    of the backbone on the card against the CPU (TF32 off, within 1e-4 of
    the largest value), with its shape, stride and ``out_features``; (b)
    resnet50 with the cocokp heads at the JAX defaults (stride 16, 2048
    features, random from seed 0) on the module graph that ``'auto'``
    picks: fields against the CPU, the main path's requests with the
    CifHr launches read around them (counted in the kernels line), a
    bf16 forward against float32, and the batch-1 forward profile in
    float32 and bf16; (c) ``python -m openpifpaf_tpu_torch.eval`` on the
    card over a synthetic COCO set (4 images of 427x569, seed 0) with that
    resnet50 saved as a checkpoint of the port, at long edge 641: 10 finite
    stats of every image, nn and decoder time per image; the ground truth
    as predictions through ``metric.Coco`` gives AP 1.0; ``benchmark.py``
    runs one entry over 2 images;
13. tracking: (a) a full-width tshufflenetv2k16 tracking model (the
    cocokpst heads: 17 CIF fields, 19 CAF and 17 TCAF edges; random, seed
    0) served by ``Predictor`` on 3 frames of 481x641 (padded to 513x641)
    on the card against the CPU, float32 with TF32 off, within 1e-4 of
    each head's largest value, and frame 2's Tcaf on the cached features
    of frame 1; (b) the frames of ``tests/golden/torch_tracking_golden.npz``
    (written with the JAX package) through the port's tracking ``Multi``
    (CifCaf and TrackingPose, CifHr through the kernel): each frame's
    annotations and track ids within the decode gate, CifHr launches,
    decode ms, device ops, syncs and busy time per frame; (c)
    ``openpifpaf_tpu_torch.video`` on the card over 4 synthetic JPEGs with
    that model saved as a checkpoint of the port: 8 JSON lines, per-frame
    NN ms (CUDA events), decode ms and device-busy share, peak memory,
    CifHr launches (counted in the kernels line);
14. tracking training and PoseTrack eval, on a synthetic COCO set (as in
    phase 11): (a) one cocokpst train step of the full-width
    tshufflenetv2k16 (random, seed 0) on the first of the 4 pairs of a
    batch (2 interleaved frames at
    385 px) of the port's cocokpst pipeline on the card against the same
    step on the CPU in float64, as in 11a; (b) ``train.main --dataset
    cocokpst --basenet tshufflenetv2k16`` for 4 steps at the JAX defaults
    (batch 8, 385 px, augmentation, SGD) in float32: warm step ms, images
    per second, loader share, peak memory, and ``load_shell`` reads the
    checkpoint as a TrackingShell, then one more step profiled (as after
    11b: device ops, syncs, busy ms, the step's peak memory); (c)
    ``eval.main --dataset
    posetrack2018 --write-predictions`` with that checkpoint over two
    synthetic PoseTrack 2018 sequences of 4 frames of 720x1280
    (``torch_port_helpers.write_synthetic_posetrack2018``, seed 0) at the
    default long edge 801, batch 1: the CifHr launches of CifCaf and of
    TrackingPose per frame (counted in the kernels line), NN and decode ms
    per frame, ``eval_reset`` once at the sequence boundary, one
    prediction JSON per sequence.
15. the keypoint plugins (``KpDataModule``, plugin discovery): (a) the
    port's CifCaf at 133 keypoints on the two contested wholebody scenes
    of ``tests/golden/torch_wholebody_golden.npz`` (written with the JAX
    package): the JAX poses within the decode gate, one CifHr launch per
    tier, warm decode ms, device ops, syncs and busy time per scene; (b)
    on a synthetic COCO-WholeBody set in pifpaf style (80 JPEGs of
    427x569, 133 keypoints posed from ``WHOLEBODY_STANDING_POSE``,
    ``torch_port_helpers.write_synthetic_wholebody``, seed 0) one step of
    the full-width shufflenetv2k16 with the wholebody heads on the first
    image of a batch of 2 on the card against the CPU's float64 step, as
    in 11a, then
    ``train.main --dataset wholebody`` for 4 steps at the JAX defaults
    (batch 8, 385 px, augmentation, SGD, float32), as in 11b; (c)
    ``predict.main --checkpoint`` of that checkpoint over 481x641 JPEGs
    (three single-image requests, one batch of two): 133x5 CIF and 160x8
    CAF fields at 33x41, one CifHr launch per image per tier, NN and
    decode ms per image, a profiled request's device ops, syncs and busy
    share; (d) ``eval_cli.main --dataset wholebody`` with it over 2
    synthetic images at long edge 641: ten finite ``WholeBodyMetric``
    stats, nn and decoder ms per image, and the ground truth as
    predictions gives AR 1.0 for each part and AP 1.0 for each part that
    every person shows; (e) crowdpose, animal, apollo (24) and apollo
    (66) each served by a random full-width k16 with its heads (one
    request, field shapes, CifHr launches), then the tracking benchmark
    wrapper's ``--crowdpose`` over a synthetic CrowdPose set of 4 images
    whose ``crowdIndex`` values cover the three buckets: each bucket's
    eval sees the ids of the JAX package's buckets. In (a) and (c)-(e)
    the kernel on the cells of every CifHr call (F=133 in (a)-(d)) equals
    its plain version bit for bit. The CifHr launches of (c)-(e) are
    counted in the kernels line.
16. detection (CifDet): (a) ``decoder.CifDet.batch_decode`` on the card on
    the two 80-category scenes of ``tests/golden/torch_cifdet_golden.npz``
    (written with the JAX package) under each configuration: JAX's
    detections on every seed slot (keep mask and categories equal, scores
    within 2e-6, boxes within 1e-3 px), warm decode ms, device ops, stream
    syncs and busy ms per decode; (b) a full-width shufflenetv2k16 with the
    cocodet head (random, seed 0) answers the main path's requests on the
    module graph, then with ``backbone_engine`` ``'pallas'`` and
    ``'dwpallas'``: (80, 6, 33, 41) fields, each engine's equal to the
    module graph's (TF32 off), its kernel launching 13 times per forward
    (counted in the kernels line), NN and decode ms per image; (c) on a
    synthetic COCO detection set (80 JPEGs of 427x569 with 1-5 boxes of
    several categories, some crowds, no keypoints,
    ``torch_port_helpers.write_synthetic_cocodet``, seed 0) one step of
    that model on the first image of a batch of 2 against the CPU's
    float64 step, as in 11a,
    then ``train.main --dataset cocodet`` for 4 steps at the JAX defaults
    (batch 8, 513 px, augmentation, SGD, float32), as in 11b, and
    ``predict.main --checkpoint`` of its checkpoint writing the detections'
    JSON; (d) ``eval_cli.main --dataset cocodet`` with it over 4 synthetic
    images at long edge 641: the ten finite bbox stats of ``metric.Coco``,
    nn and decoder ms per image; the ground truth as predictions gives AP
    and AR 1.0; (e) random resnet18 and mobilenetv3small with the cocodet
    head and k16 with the nuscenes head (23 categories), one request each
    with its field shapes, then ``train.main --dataset cifar10 --basenet
    cifar10net`` for 4 steps on synthetic CIFAR batches and ``eval_cli.main
    --dataset cifar10``: a finite ``Classification`` accuracy.
17. multi-dataset training and the Predictor's test-time options: (a)
    on a synthetic COCO keypoint set and a synthetic COCO detection set
    (80 JPEGs each, seed 0) ``train.main --dataset cocokp-cocodet
    --dataset-weights 2 1`` for 4 steps with k16 at full width (batch 8,
    385 px, float32), as in 11b: the dataset of each step (read from the
    None pattern of its logged head losses) in the ``MultiLoader`` order
    computed on the host, and the checkpoint's three heads; (b) that
    checkpoint through ``Predictor(checkpoint=...)``, ``Multi`` of
    CifCaf and CifDet: its hflip TTA fields against the CPU's and each
    engine's against the module graph's (TF32 off); the module graph and
    ``'pallas'`` serving one 481x641 JPEG plain, with ``hflip_tta``,
    ``multi_scale`` (long edges 641, 481, 961) and both, ``'dwpallas'``
    with ``hflip_tta``: NN and decode ms per image, the engine's kernel
    launching 13 times per forward, every CifHr call held bit for bit
    against its plain version; ``pil_images``, ``numpy_images`` and
    prefetch depth 0 answering as ``images``; a batch of 16 forwarded in
    chunks of 8 and whole, fields and NN ms per image; (c)
    ``eval_cli.main --dataset cocokp --hflip-tta`` with that checkpoint
    over 2 synthetic images at long edge 641: ten finite stats, nn and
    decoder ms per image, every CifHr call bit-equal to its plain
    version, the ground truth as predictions AP 1.0. The CifHr, depthwise
    and fused-block launches of (b) and (c) are counted in the kernels
    line.

18. reference checkpoints: a full-width shufflenetv2k16 in the reference's
    module layout (``tests/torch_ref.py``, random from seed 0, BatchNorm
    running statistics drawn from seed 1, confidences raised by 2), saved
    as the reference saves checkpoints (``ref.pkl``, epoch 3): (a) its raw
    head outputs through ``Predictor(checkpoint='ref.pkl')`` on the module
    graph within 1e-5 of each head's largest value of the ``torch_ref``
    forward on the card, on ``'pallas'``, ``'dwpallas'`` and ``'folded'``
    within ``ENGINE_TOL`` (TF32 off); ``predict.main --checkpoint
    ref.pkl`` over the main path's requests as 481x641 JPEGs on each of
    the four engines (lowered thresholds, pose budgets of 16): NN and
    decode ms per image, one CifHr launch per image per tier, the
    engine's kernel 13 times per forward, every CifHr call bit-equal to
    its plain version; ``migrate`` of the pickle serves the same poses;
    (b) ``predict --checkpoint shufflenetv2k16-apollo-66`` from a cache
    directory (``OPENPIFPAF_TPU_CACHE``) holding a 66-keypoint
    reference-layout pickle under the registered URL's file name, with
    downloads refused, then a hash-suffixed name whose cached file fails
    its check raises; (c) ``train.main --checkpoint ref.pkl`` for 2 steps
    on a synthetic cocokp set (batch 8, 385 px) from the pickle's epoch;
    (d) ``count_ops.main --checkpoint ref.pkl``: GFLOPs and parameters.
    The CifHr, depthwise and fused-block launches of (a) and (b) are
    counted in the kernels line.
19. drawing: a full-width shufflenetv2k16 with the cocokp heads, random
    from seed 0, its heads made to decode to whole people
    (``torch_port_helpers.posed_model``), saved as a checkpoint of the
    port: (a) ``predict.main`` over the main path's requests as 481x641
    JPEGs on ``--backbone-engine pallas`` and ``dwpallas`` with 18a's
    lowered thresholds and pose budgets of 16, ``--show-decoding-order
    --show-frontier-order --show-joint-scales`` and, where matplotlib is
    installed, ``-o``, ``--debug-indices cif:0 caf:0`` and ``--save-all``:
    every annotation's decoding order a growth from one seed, one CifHr
    launch per image per tier with each call bit-equal to its plain
    version, the engine's kernel 13 times per forward, NN and decode ms
    per image; with matplotlib also every ``-o`` image of the input's
    size, 4 ``--save-all`` figures per decode and the draw ms per image
    (host clock, painter to ``savefig``); (b) the golden 3-person scene
    decoded on the card by a decoder that ``show.configure`` of
    ``--show-decoding-order --show-frontier-order`` switched to export
    its orders: JAX's poses, decoding and frontier orders (and, with
    matplotlib, drawn); with matplotlib, (c) ``video.main --video-output``
    over phase 13's 4 JPEGs (an mp4 where matplotlib has ``ffmpeg``, one
    JPEG per frame otherwise) and (d) ``eval_cli.main
    --eval-show-final-image --eval-show-final-ground-truth`` over 4
    synthetic images; then every show and visualizer flag parsed by the
    predict CLI into the state it configures, and video's and eval's
    drawing flags. Without matplotlib a line says so and nothing is
    drawn. The CifHr, depthwise and fused-block launches of (a), (c) and
    (d) are counted in the kernels line.
20. deployment, with phase 19's posed k16 saved as a checkpoint of the
    port: (a) ``python -m openpifpaf_tpu_torch.export --checkpoint`` on
    the card, in processes of their own, of its fields program and, with
    ``--with-decoder``, of its forward and CifCaf decode as one program
    (481x641 input): wall seconds and ``.pt2`` bytes; each loaded with
    ``torch.export.load`` and run on the main path's requests as 481x641
    images: the fields within 1e-4 of each head's largest value of the
    eager module graph (TF32 off), the poses within the pose gate of the
    eager ``build_cifcaf_decoder`` on the card (and whether bit-equal),
    every CifHr call of the program a counted kernel launch bit-equal to
    its plain version; the program's NN and decode ms per image beside
    the eager standard tier's (CUDA events), the device ops and stream
    syncs of one exported decode, each fixpoint's ``while_loop``
    rounds, and the eager decode with the growth's two forms (live lanes
    gathered, every lane grown) in 2 alternating pairs; then the decode
    alone exported on the card (a process of its own), loaded and run on
    the posed fields, on 3 people drawn by the port's encoders (kept
    whole) and on the random k16's sparse fields: bit-equal to the eager
    decode, every CifHr call a counted launch bit-equal to its plain
    version, decode ms per image of both, and the growth's two forms on
    the sparse request; (b) ``jpeglib.h`` probed and the native JPEG
    loader built,
    its normalised batch within 0.5 (mean abs) of the PIL path's, load ms
    per batch of each, then ``predict --long-edge 641`` over the requests
    on ``pallas`` and ``dwpallas`` through the native loader and through
    PIL: the loader ``images`` took, NN and decode ms per image, launches,
    every CifHr call bit-equal to its plain version, and the two loaders'
    poses compared (where the loader does not build, a line says so and
    the PIL path runs); (c) ``train.main --profile`` for 2 steps of phase
    11's k16 training: one Chrome trace per step with its device ops (a
    trace with none is reported as such), then ``cifhr.cu`` and the
    native loader built with ``--xla-compilation-cache`` of a fresh
    directory in one process and loaded, not rebuilt, by a second; (d)
    ``logs --print-last`` of (c)'s log. The CifHr and engine launches of
    (a) and (b) are counted in the kernels line. (b)-(d) run while (a)'s
    three exports run in processes of their own: their times are taken
    beside those processes.

21. the pipelined serving loop and data-parallel training: (a) phase
    19's posed k16 saved as a checkpoint of the port: ``predict.main``
    over 8 random 481x641 JPEGs on ``--backbone-engine pallas`` and
    ``dwpallas`` at batch 1 and 2, pipelined (the default) and with
    ``--no-pipeline-decode``: the annotations bit-equal between the loops
    and to ``CifCaf.batch_decode`` called directly on each image's
    fields, every CifHr call a counted launch on the decode's side stream
    (not the default stream) bit-equal to its plain version, the engine's
    kernel 13 times per forward, wall, NN and decode ms per image of both
    loops; ``--decode-device 0`` (the machine has one card); one
    pipelined run in a ``torch.profiler`` trace: the fused block's
    launches that ran while a decode materialised, CifHr's stream against
    the forward's, the device's busy share; ``eval_cli.main
    --pipeline-decode`` on phase 12's synthetic set gives the strict
    loop's stats and predictions; (b) ``train.main --n-devices 1`` (DDP,
    NCCL at world size 1, the cross-rank BatchNorm) for 3 steps against
    the plain single-process run on the same batches, and ``predict
    --n-devices 2`` raising on one card. The launches of (a) are counted
    in the kernels line.

22. the C++ runner: (a) after phase 11, beside phases 12-21, phase 19's
    posed k16 exported with ``python -m openpifpaf_tpu_torch.export
    --format savedmodel`` at 481x641, with ``--with-decoder`` (an
    AOTInductor package of the (poses, keep) program) and without it (of
    the fields), each in a process of its own (wall seconds and bytes),
    and the C++ runner and its CifHr operator library built from this
    checkout's sources (``python -m openpifpaf_tpu_torch.cpp_runner``:
    CMake where it is on the path; build seconds, and whether
    ``jpeglib.h`` was found, else the image runner reads PPM alone), the
    three processes at a lower priority (``nice``); (b) both packages
    loaded here
    (``torch._inductor.aoti_load_package``) and run on phase 21's 8
    images: the fields within 1e-3 of the eager module graph's (TF32 off);
    keep equal and every lane within the pose gate of the eager
    ``build_cifcaf_decoder`` and of phase 20's decode-only ``.pt2``
    program on the fields package's fields (whether bit-equal, the largest
    differences; the random model's decode moves with 1e-6 of noise in
    its fields, so the end-to-end difference is reported, not gated),
    every CifHr call a counted launch bit-equal to its plain version, NN
    plus decode ms per image of the package, phase 20's ``.pt2`` program
    and the eager decode (CUDA events) and their device ops and syncs; (c)
    the image runner on those images as 481x641 PPMs: every lane equal to
    the Python-loaded package's on the same input (its ``--verbose`` sums,
    exactly), one JSON line each equal to the kept poses through JAX's
    extraction formula to the printed precision, its wall seconds for the
    list and per image after the first, and its C++ operator's CifHr
    launches, one per image; (d) the video runner on a 3-frame clip where
    OpenCV let it be built, else a line saying it was not. The launches of
    (b)-(d) are counted in the kernels line.

The second-to-last line is a JSON object describing the kernels (with each
one's bound: the larger of its bytes over the card's memory rate and its
operations over the peak rate of its type), the last
``{"ok": true, "device": {...}}``.
"""

import contextlib
import functools
import gc
import json
import logging
import os
import re
import subprocess
import sys
import tempfile
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, 'tests', 'golden', 'torch_decode_golden.npz')
#: (n_fields, n_cells): COCO-17 and wholebody-133 at the fast and crowd
#: tiers
KERNEL_SHAPES = ((17, 256), (17, 1024), (133, 256), (133, 1024))
HR_SHAPE = (513, 641)
IMAGE_HW = (481, 641)
#: fields at stride 16 of IMAGE_HW after the Predictor's bucket pad to 513x641
FIELD_HW = (33, 41)
#: the image of the engine, branch2 and profile phases
FORWARD_HW = (513, 641)
SOURCES = ('cifhr.cu', 'depthwise.cu', 'shuffle_block.cu', 'mosaic_lab.cu')
#: (Cb, H, W) of shufflenetv2k16's stages 2-4 for a 513x641 input: the
#: activations of the non-first blocks are (N, 2 Cb, H, W)
STAGES = ((174, 129, 161), (348, 65, 81), (696, 33, 41))
#: non-first blocks of shufflenetv2k16 (3 + 7 + 3): stride-1 depthwise
#: convs and fused blocks per forward
FORWARD_LAUNCHES = 13
#: kernel vs plain: float32 differs by summation order only; bfloat16 by
#: at most one rounding step of the largest output
F32_ATOL = 1e-5
BF16_RTOL = 2.0 ** -7
#: engine vs module graph fields, float32 with TF32 off (BatchNorm folded
#: into the weights rounds differently)
ENGINE_TOL = dict(rtol=1e-4, atol=1e-4)
#: bfloat16 backbone vs float32: max abs error within this share of the
#: head's largest field value
BF16_FIELD_RTOL = 5e-2
#: lab kernel vs plain, float32: summation order, as a share of the largest
#: output (bfloat16: BF16_RTOL)
LAB_F32_RTOL = 1e-5
#: the card's published peaks (H100 SXM data sheet; dense, at 700 W):
#: memory bytes/s, and operations/s by the inputs' type (float32 on CUDA
#: cores, bfloat16 on tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}
#: float operations of one pixel of a CifHr splat in cifhr.cu (distance,
#: approx_exp, weighted add)
CIFHR_OPS_PER_PIXEL = 13
#: bytes written between calls for a cold-L2 time (the card's L2 is 50 MB)
FLUSH_BYTES = 96 << 20


def log(*args):
    print(*args, flush=True)


def card_line():
    done = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60)
    return done.stdout.strip().splitlines()[0]


def import_port():
    """The port's modules and the test helpers (pose gate, seeded cells)
    of this checkout."""
    sys.path[:0] = [ROOT, os.path.join(ROOT, 'tests')]
    import openpifpaf_tpu_torch
    if not os.path.abspath(openpifpaf_tpu_torch.__file__).startswith(ROOT):
        raise RuntimeError('openpifpaf_tpu_torch imported from '
                           f'{openpifpaf_tpu_torch.__file__}, not {ROOT}')
    from openpifpaf_tpu_torch import _nvcc
    from openpifpaf_tpu_torch.lab import kernels as lab_kernels
    from openpifpaf_tpu_torch.lab import mosaic_lab
    from openpifpaf_tpu_torch.models import block_cuda, dw_cuda, \
        fused_inference, shuffle_cuda
    from openpifpaf_tpu_torch.ops import cifhr, cifhr_cuda
    return types.SimpleNamespace(
        nvcc=_nvcc, cifhr=cifhr, cifhr_cuda=cifhr_cuda, dw_cuda=dw_cuda,
        shuffle_cuda=shuffle_cuda, block_cuda=block_cuda,
        fused_inference=fused_inference, lab_kernels=lab_kernels,
        mosaic_lab=mosaic_lab)


@contextlib.contextmanager
def no_tf32():
    """Float32 convolutions and matmuls in full float32."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def launch_counters(port):
    return {'cifhr_accumulate': port.cifhr_cuda,
            'depthwise_conv': port.dw_cuda,
            'shuffle_block': port.shuffle_cuda,
            'shuffle_branch2': port.block_cuda}


def reset_launches(port):
    for module in launch_counters(port).values():
        module.LAUNCHES = 0
    for name in port.lab_kernels.LAUNCHES:
        port.lab_kernels.LAUNCHES[name] = 0


def read_launches(port):
    counts = {name: module.LAUNCHES
              for name, module in launch_counters(port).items()}
    counts.update(port.lab_kernels.LAUNCHES)
    return counts


def phase_build(port):
    start = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        futures = [pool.submit(port.nvcc.build, source) for source in SOURCES]
        paths = [f.result() for f in futures]
    log(f'built {", ".join(os.path.basename(p) for p in paths)} in '
        f'{time.perf_counter() - start:.1f} s')


def cuda_ms(fn, n):
    """Mean milliseconds per call over ``n`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def tensors_of(*args):
    """The tensors among ``args``, a weights dataclass (``.tensors()``)
    giving its own."""
    out = []
    for a in args:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif hasattr(a, 'tensors'):
            out.extend(a.tensors())
    return out


def bound(inputs, outputs, ops, dtype):
    """``(ms, 'bytes' or 'operations')``: the least time the card could take
    for the work, the larger of each input read once and each output written
    once at HBM_BYTES_PER_S, and ``ops`` operations at the peak rate of
    ``dtype``."""
    n_bytes = sum(t.numel() * t.element_size()
                  for t in tensors_of(*inputs, *outputs))
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (bytes_ms, 'bytes') if bytes_ms >= ops_ms else \
        (ops_ms, 'operations')


def conv_ops(name, args, out):
    """Operations of a backbone or lab kernel giving ``out`` from ``args``:
    two per multiply-add of its depthwise taps and 1x1 products (biases,
    activations and copies are not counted; the interleave only copies)."""
    n, _, h, w = out.shape
    if name in ('depthwise_conv', 'lab_dw_valid'):
        k = args[1].shape[-1]
        return 2 * k * k * out.numel()
    if name in ('shuffle_block', 'shuffle_branch2', 'lab_branch2'):
        w1, _, wdw = args[1].tensors()[:3]
        cb, k = w1.shape[0], wdw.shape[-1]
        return n * h * w * (4 * cb * cb + 2 * k * k * cb)
    return 0


def cifhr_splat_pixels(x, y, sigma, w, hr_h, hr_w):
    """Map pixels within one sigma of a cell of non-zero weight, summed
    over the cells: the splat work that these cells need."""
    xs = torch.arange(hr_w, dtype=torch.float32, device=x.device)
    ys = torch.arange(hr_h, dtype=torch.float32, device=x.device)
    total = torch.zeros((), dtype=torch.int64, device=x.device)
    for k in range(x.shape[1]):
        d2 = (xs[None, None, :] - x[:, k, None, None]) ** 2 + \
            (ys[None, :, None] - y[:, k, None, None]) ** 2
        total += ((d2 <= sigma[:, k, None, None] ** 2)
                  & (w[:, k, None, None] != 0)).sum()
    return int(total)


def device_ops(fn, n=1):
    """Names of the device ops of ``n`` calls of ``fn`` in one
    ``torch.profiler`` session, after one call outside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


def start_profiler():
    """Profile small ops until a session records a device op: the
    profiler's first session in a process can miss every launch (and any
    session its first ones), so the sessions that count come after this."""
    x = torch.ones(1024, device='cuda')
    for _ in range(5):
        if device_ops(lambda: x.add_(1), 10):
            return
    raise AssertionError('torch.profiler recorded no device op in 5 '
                         'sessions of 10 launches')


#: calls in one session of the one-op-per-call check
OPS_CHECK_CALLS = 10
#: sessions of that check taken while they record no device op at all
PROFILER_TRIES = 3


def phase_kernel(cifhr, cifhr_cuda, device, card):
    """The CifHr kernel against its plain version, bit for bit, on seeded
    random cells at KERNEL_SHAPES and on the golden file's sparse and crowd
    cells at both tiers' budgets: its launch plan, one device op per call,
    the call time (CUDA events, host included), the device time alone, the
    device time with a cold L2 (FLUSH_BYTES written between calls) and the
    card's write floor (``zero_`` of the same map, not the same function);
    returns one row per case."""
    from openpifpaf_tpu_torch.lab.timing import device_ms
    from torch_port_helpers import cifhr_cases

    kw = dict(hr_h=HR_SHAPE[0], hr_w=HR_SHAPE[1])
    flush_buffer = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=device)
    floors = {}
    rows = []
    for label, cells in cifhr_cases(KERNEL_SHAPES, *HR_SHAPE,
                                    device).items():
        n_fields, n_cells = cells[0].shape
        plan = cifhr_cuda.plan(n_fields, n_cells, *HR_SHAPE)
        kernel = cifhr_cuda.accumulate(*cells, **kw)
        plain = cifhr.accumulate_dense(*cells, **kw)
        torch.cuda.synchronize()
        err = float((kernel - plain).abs().max())
        if not torch.equal(kernel, plain):
            raise AssertionError(f'CifHr kernel vs plain at {label}: not '
                                 f'bit-equal, max abs err {err}')
        call = functools.partial(cifhr_cuda.accumulate, *cells, **kw)
        # the profiler can miss a session's first launches, and now and
        # then every launch of a session: a session that recorded no op
        # is taken again (at most PROFILER_TRIES sessions); of what it
        # records, at most one op per call, each the kernel, and most
        # calls recorded
        for _ in range(PROFILER_TRIES):
            ops = device_ops(call, OPS_CHECK_CALLS)
            if ops:
                break
        if not (OPS_CHECK_CALLS // 2 <= len(ops) <= OPS_CHECK_CALLS
                and all('cifhr_band_kernel' in op for op in ops)):
            raise AssertionError(f'CifHr call at {label}: device ops {ops} '
                                 f'in {OPS_CHECK_CALLS} calls, want the '
                                 'kernel alone once per call')
        if n_fields not in floors:
            out = torch.empty_like(plain)
            floors[n_fields] = device_ms(out.zero_, 20)
        row = dict(case=label, err=err, ms=cuda_ms(call, 50),
                   plain_ms=cuda_ms(functools.partial(
                       cifhr.accumulate_dense, *cells, **kw), 1),
                   library_ms=None,
                   device_ms=device_ms(call, 20, 'cifhr_band_kernel'),
                   cold_ms=device_ms(call, 10, 'cifhr_band_kernel',
                                     between=flush_buffer.zero_),
                   floor_ms=floors[n_fields])
        splat = CIFHR_OPS_PER_PIXEL * cifhr_splat_pixels(*cells, *HR_SHAPE)
        row['bound_ms'], row['bound_by'] = bound(cells, [kernel], splat,
                                                 torch.float32)
        rows.append(row)
        log(f'cifhr {label} map={HR_SHAPE}: plan '
            f'{cifhr_cuda.describe(plan)}; max_abs_err {err} (bit for bit), '
            f'1 device op per call; call {row["ms"]:.4f} ms, device alone '
            f'{fmt_ms(row["device_ms"])}, cold L2 {fmt_ms(row["cold_ms"])}, '
            f'write floor (zero_ of the map, not the same function) '
            f'{fmt_ms(row["floor_ms"])}, plain {row["plain_ms"]:.3f} ms, '
            f'bound {row["bound_ms"]:.4f} ms by {row["bound_by"]} [{card}]')
    return rows


def phase_golden(cifhr_cuda, device, card):
    from openpifpaf_tpu_torch.decoder import CifCaf
    from openpifpaf_tpu_torch.models.shell import assign_strides
    from openpifpaf_tpu_torch.plugins.coco.constants import cocokp_head_metas
    from torch_port_helpers import assert_pose_gate

    golden = np.load(GOLDEN)
    names = ('sparse', 'crowd')
    fields = [torch.from_numpy(np.stack([golden[f'{n}_{head}']
                                         for n in names])).to(device)
              for head in ('cif', 'caf')]
    decoder = CifCaf(*assign_strides(cocokp_head_metas(), 16))
    before = cifhr_cuda.LAUNCHES
    annotations = decoder.batch_decode(fields)
    if cifhr_cuda.LAUNCHES <= before:
        raise AssertionError('golden decode did not launch the CifHr kernel')
    if decoder.last_escalated != [1]:
        raise AssertionError('expected the 40-person scene (and only it) to '
                             f'escalate, got {decoder.last_escalated}')
    for name, anns in zip(names, annotations):
        ours = [np.concatenate([a.data[:, 2:3], a.data[:, :2],
                                a.joint_scales[:, None]], axis=1)
                for a in anns]
        assert_pose_gate(ours, list(golden[f'{name}_poses']))
        log(f'golden {name}: {len(ours)} poses match the JAX decode')
    log(f'golden decode: crowd tier taken for image 1 only, '
        f'{cifhr_cuda.LAUNCHES - before} kernel launches')

    # warm decode time of each scene alone, batch 1 (the crowd scene
    # includes its fast-tier try and the crowd-tier re-decode)
    for i, name in enumerate(names):
        one = [f[i:i + 1] for f in fields]
        seconds = []
        for _ in range(3):
            decoder.batch_decode(one)
            seconds.append(decoder.last_decoder_time)
        log(f'golden {name} decode, batch 1, warm: median '
            f'{np.median(seconds[1:]) * 1e3:.2f} ms of '
            f'{[round(s * 1e3, 2) for s in seconds[1:]]} [{card}]')


#: the CUDA runtime calls that wait for the card, in a profiled run
SYNC_CALLS = ('cudaStreamSynchronize', 'cudaDeviceSynchronize',
              'cudaEventSynchronize')


def decode_profile(fn):
    """(device ops, stream syncs, device busy ms) of one call of ``fn``
    from ``torch.profiler``: the CUDA device events, the CUDA runtime's
    synchronising calls (less the profiler's closing one) and the sum of
    the device events' times. It reads the profiler's raw events: the
    tree of ``prof.events()`` costs seconds of host time per decode."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    ops = [e for e in events if e.device_type() == DeviceType.CUDA]
    syncs = sum(e.device_type() == DeviceType.CPU
                and e.name() in SYNC_CALLS for e in events) - 1
    busy = sum(e.duration_ns() for e in ops) / 1e6
    return len(ops), syncs, busy


def phase_configs(cifhr_cuda, device, card):
    """Every run of ``golden_runs`` on the card, each decoder built from
    its CLI flags: the golden JAX poses within the gate, the decoding
    order and ids where the golden file has them, the crowd tier for the
    40-person scene only, the CifHr kernel's launches as the run expects;
    then the warm batch-1 decode time (median of 2 after one), and the
    device ops, stream syncs and device busy time of one profiled
    decode."""
    from torch_port_helpers import GOLDEN_STRIDE, assert_pose_gate, \
        golden_inputs, golden_runs, order_rows, port_decoder, pose_rows

    golden = np.load(GOLDEN)
    for label, scene, config, flags, overrides, key, kernel in golden_runs():
        decoder = port_decoder(GOLDEN_STRIDE, flags, overrides)
        fields, initial = golden_inputs(golden, scene, config, key, device)

        def decode():
            return decoder.batch_decode(fields, initial)[0]

        before = cifhr_cuda.LAUNCHES
        anns = decode()
        launches = cifhr_cuda.LAUNCHES - before
        if (launches > 0) != kernel:
            raise AssertionError(f'config {label}: {launches} CifHr kernel '
                                 f'launches, want {"some" if kernel else 0}')
        assert_pose_gate(list(pose_rows(anns)), list(golden[f'{key}_poses']))
        if f'{key}_order' in golden.files:
            np.testing.assert_array_equal(order_rows(anns),
                                          golden[f'{key}_order'])
        if f'{key}_ids' in golden.files:
            ids = [-1 if a.id_ is None else a.id_ for a in anns]
            np.testing.assert_array_equal(ids, golden[f'{key}_ids'])
        want = [0] if scene == 'crowd' else []
        if decoder.last_escalated != want:
            raise AssertionError(f'config {label}: crowd tier for '
                                 f'{decoder.last_escalated}, want {want}')
        seconds = []
        for _ in range(3):
            decode()
            seconds.append(decoder.last_decoder_time)
        ms = float(np.median(seconds[1:])) * 1e3
        ops, syncs, busy = decode_profile(decode)
        log(f'config {label}: {len(anns)} poses match the JAX decode'
            f'{" (decoding order too)" if key + "_order" in golden.files else ""}'
            f', {launches} CifHr kernel launches, crowd tier for '
            f'{decoder.last_escalated}; warm batch-1 decode {ms:.2f} ms '
            f'(median of {[round(t * 1e3, 2) for t in seconds[1:]]}), '
            f'{ops} device ops, {syncs} stream syncs, device busy '
            f'{busy:.3f} ms per decode [{card}]')


def check_fields_against_cpu(predictor, device):
    """The model's fields on the GPU against the same model on the CPU, on
    a small image, with TF32 off (atol/rtol 1e-4)."""
    import copy

    rng = np.random.RandomState(1)
    image = rng.randn(1, 129, 161, 3).astype(np.float32)
    cpu_model = copy.deepcopy(predictor.model).to('cpu')
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            gpu = predictor.model(torch.from_numpy(image).to(device))
            cpu = cpu_model(torch.from_numpy(image))
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    for g, c in zip(gpu, cpu):
        np.testing.assert_allclose(g.cpu().numpy(), c.numpy(),
                                   rtol=1e-4, atol=1e-4)
    log('fields on the GPU match the CPU forward (TF32 off, atol 1e-4)')


def compare_and_time(name, case, call, plain, library, args, kw, dtype,
                     f32_tol, card):
    """``call`` against ``plain`` on ``args``, raising beyond the
    tolerance (float32: ``f32_tol(ref)``; bfloat16: one rounding step of
    the largest output), then each one's time and ``library``'s (one
    PyTorch call of the same function, or None) and the work's bound.
    Returns the row as a dict."""
    out = call(*args, **kw)
    ref = plain(*args, **kw)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    tol = f32_tol(ref) if dtype == torch.float32 else \
        BF16_RTOL * float(ref.float().abs().max())
    if not err <= tol:
        raise AssertionError(f'{name} kernel vs plain at {case}: max abs '
                             f'err {err}, tol {tol}')
    row = dict(case=case, dtype=dtype, err=err, tol=tol,
               ms=cuda_ms(functools.partial(call, *args, **kw), 20),
               plain_ms=cuda_ms(functools.partial(plain, *args, **kw), 20),
               library_ms=None if library is None else cuda_ms(
                   functools.partial(library, *args), 20))
    row['bound_ms'], row['bound_by'] = bound(args, [out],
                                             conv_ops(name, args, out), dtype)
    library_text = 'none' if library is None else \
        f'{row["library_ms"]:.4f} ms'
    log(f'{name} {case}: max_abs_err {err} (tol {tol:.3g}), kernel '
        f'{row["ms"]:.4f} ms, plain {row["plain_ms"]:.4f} ms, library '
        f'{library_text}, bound {row["bound_ms"]:.4f} ms by '
        f'{row["bound_by"]} per call [{card}]')
    return row


def launch_plan(port, name, args, kw):
    """The launch plan the wrapper of backbone or lab kernel ``name`` takes
    for ``args``, as text."""
    x = args[0]
    n, c, h, w = x.shape
    align = port.dw_cuda.alignment
    if name == 'lab_interleave':
        ctas = min(-(-x.numel() // 256), 1 << 20)
        return f'{ctas} CTAs of 256 threads, one (a, b) pair per thread'
    if name in ('depthwise_conv', 'lab_dw_valid'):
        k = args[1].shape[-1]
        valid = name == 'lab_dw_valid'
        if valid:  # planned for the output's size
            h, w = h - k + 1, w - k + 1
        p = port.dw_cuda.plan(n, h, w, c, k=k,
                              dilation=kw.get('dilation', 1), dtype=x.dtype,
                              align=align(x), valid=valid)
        return (f'vec {p.vec}, {p.nv} vectors x {p.groups} groups, tile '
                f'{p.strips * port.dw_cuda.strip_rows(p.vec)}x{p.tw}, '
                f'{p.threads} threads, {p.ctas} CTAs, {p.smem} shared bytes')
    wt = args[1]
    if name == 'lab_branch2':
        k = wt.wd.shape[-1]
        p = port.lab_kernels.branch2_plan(
            n, h - k + 1, w - k + 1, c, k=k, dtype=x.dtype,
            align=align(x, wt.w1, wt.w3))
    else:
        p = port.shuffle_cuda.plan(n, h, w, c // 2, k=kw['k'],
                                   dilation=kw['dilation'], dtype=x.dtype,
                                   align=align(x, wt.w1, wt.w3))
    resident = port.shuffle_cuda.resident_clusters(p, dtype=x.dtype,
                                                   device=x.device)
    return (f'tile {p.th}x{p.tw}, cluster {p.cluster} x {p.slice} channels, '
            f'{p.ctas} CTAs ({resident} clusters resident at once), '
            f'{p.smem} shared bytes, {p.vb}-byte copies')


#: the backbone kernels' names in their sources
BACKBONE_SYMBOLS = {'depthwise_conv': 'depthwise_kernel',
                    'shuffle_block': 'shuffle_block_kernel',
                    'shuffle_branch2': 'shuffle_block_kernel'}


def phase_backbone_kernels(port, device, card):
    """Each backbone kernel against its plain version, with its launch
    plan, its device time alone and the library call's (``torch.profiler``)
    and, at stage 2, its device time with a cold L2; returns
    {name: [row of :func:`compare_and_time`, ...]}."""
    from openpifpaf_tpu_torch.lab.timing import device_ms
    from torch_port_helpers import backbone_kernel_inputs

    kernels = {
        'depthwise_conv': (port.dw_cuda.depthwise_conv,
                           port.dw_cuda.depthwise_conv_plain),
        'shuffle_block': (port.shuffle_cuda.fused_block,
                          port.shuffle_cuda.fused_block_plain),
        'shuffle_branch2': (port.block_cuda.branch2_apply,
                            port.shuffle_cuda.branch2_plain),
    }
    # the model's stage shapes (depthwise without activation, as in the
    # model), and a small dilated leaky case
    cases = [((1, 2 * cb, h, w), 5, 1, False) for cb, h, w in STAGES]
    cases.append(((2, 24, 13, 17), 5, 2, True))
    flush_buffer = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=device)
    results = {}
    with no_tf32():
        for name, (call, plain) in kernels.items():
            results[name] = []
            symbol = BACKBONE_SYMBOLS[name]
            for dtype in (torch.float32, torch.bfloat16):
                for i, (shape, k, dilation, leaky) in enumerate(cases):
                    if name == 'depthwise_conv' and i < len(STAGES):
                        shape = (1, shape[1] // 2) + shape[2:]
                    args, kw = backbone_kernel_inputs(
                        name, shape, k=k, dilation=dilation, act=leaky,
                        leaky=leaky, dtype=dtype, device=device, seed=i)
                    case = f'{tuple(shape)} k={k} d={dilation} ' \
                        f'leaky={leaky} {str(dtype)[6:]}'
                    # one cuDNN call computes the depthwise conv without
                    # an activation; no single call computes a block
                    library = None
                    if name == 'depthwise_conv' and not leaky:
                        library = functools.partial(
                            F.conv2d, padding=(k - 1) // 2 * dilation,
                            dilation=dilation, groups=shape[1])
                    row = compare_and_time(
                        name, case, call, plain, library, args, kw, dtype,
                        lambda ref: F32_ATOL, card)
                    fn = functools.partial(call, *args, **kw)
                    row['device_ms'] = device_ms(fn, 20, symbol)
                    row['library_device_ms'] = None if library is None \
                        else device_ms(functools.partial(library, *args), 20)
                    row['cold_ms'] = device_ms(
                        fn, 10, symbol, between=flush_buffer.zero_) \
                        if i == 0 else None
                    results[name].append(row)
                    plan = launch_plan(port, name, args, kw)
                    log(f'{name} {case}: plan {plan}; device time alone '
                        f'{fmt_ms(row["device_ms"])}, cold L2 '
                        f'{fmt_ms(row["cold_ms"])}, library device '
                        f'{fmt_ms(row["library_device_ms"])} [{card}]')
    return results


def fmt_ms(ms):
    return 'not measured' if ms is None else f'{ms:.4f} ms'


def make_requests():
    rng = np.random.RandomState(0)
    requests = [[rng.randint(0, 256, IMAGE_HW + (3,), dtype=np.uint8)]
                for _ in range(3)]
    requests.append([rng.randint(0, 256, IMAGE_HW + (3,), dtype=np.uint8)
                     for _ in range(2)])
    return requests


def serve(predictor, requests, card, label, heads=((17, 5), (19, 8))):
    """Answer ``requests``, check every field's shape (``heads``: fields
    and components of each head, cocokp's by default) and values and print
    each request's times; returns the number of forwards."""
    seen = []
    fields_batch = predictor.fields_batch

    def recording_fields_batch(image_batch):
        fields = fields_batch(image_batch)
        seen.append([(tuple(f.shape), bool(torch.isfinite(f).all()))
                     for f in fields])
        return fields

    predictor.fields_batch = recording_fields_batch
    timings = []
    try:
        for images in requests:
            predictor.batch_size = len(images)
            start = time.perf_counter()
            out = list(predictor.numpy_images(images))
            e2e = time.perf_counter() - start
            if len(out) != len(images):
                raise AssertionError(f'{len(out)} answers for {len(images)}')
            timings.append((len(images), e2e, predictor.last_nn_time,
                            predictor.last_decoder_time,
                            getattr(predictor.processor.decoders[0],
                                    'last_escalated', []),
                            [len(pred) for pred, _, _ in out]))
    finally:
        del predictor.fields_batch

    for (b, *_), shapes in zip(timings, seen):
        want = [((b,) + head + FIELD_HW, True) for head in heads]
        if shapes != want:
            raise AssertionError(f'{label}: fields {shapes}, want {want}')
    for i, (b, e2e, nn_s, dec_s, escalated, n_anns) in enumerate(timings):
        log(f'{label} request {i} batch {b}: e2e {e2e / b * 1e3:.2f} '
            f'ms/image, NN {nn_s / b * 1e3:.2f} ms/image, '
            f'decode {dec_s / b * 1e3:.2f} ms/image, crowd tier for '
            f'{escalated}, annotations {n_anns}'
            f'{" (first call, warm-up)" if i == 0 else ""} [{card}]')
    return len(seen)


def flagged_predictor(model, device, flag):
    """A Predictor of ``model`` whose decoder the predict CLI configured
    with ``flag`` (the decoder's class settings are put back after)."""
    from openpifpaf_tpu_torch import decoder, predict
    from openpifpaf_tpu_torch.predictor import Predictor
    from torch_port_helpers import restored_statics

    with restored_statics(*decoder.DECODERS):
        predict.cli(['request.jpg', flag])
        return Predictor(model=model, device=device)


def phase_main_path(port, device, card):
    from openpifpaf_tpu_torch.predictor import Predictor

    predictor = Predictor(device=device)
    check_fields_against_cpu(predictor, device)
    flagged = {flag: flagged_predictor(predictor.model, device, flag)
               for flag in ('--force-complete-pose', '--greedy')}
    for flag, field in (('--force-complete-pose', 'force_complete'),
                        ('--greedy', 'greedy')):
        if not getattr(flagged[flag].processor.decoders[0].config, field):
            raise AssertionError(f'{flag} did not reach the decoder')
    reset_launches(port)
    serve(predictor, make_requests(), card, 'module graph')
    for flag, p in flagged.items():
        serve(p, make_requests()[:1], card, f'module graph {flag}')
    launches = read_launches(port)
    if launches['cifhr_accumulate'] == 0:
        raise AssertionError('main path never launched the CifHr kernel')
    log(f'main path: {launches["cifhr_accumulate"]} CifHr kernel launches')
    return predictor, launches['cifhr_accumulate']


def test_image(device):
    rng = np.random.RandomState(2)
    return torch.from_numpy(rng.randn(1, *FORWARD_HW, 3).astype(
        np.float32)).to(device)


def compare_fields(out, ref, label, **tol):
    """Largest abs difference per head; raises beyond ``tol``."""
    errs = [float((o.float() - r).abs().max()) for o, r in zip(out, ref)]
    for o, r in zip(out, ref):
        torch.testing.assert_close(o.float(), r, **tol, msg=lambda m: (
            f'{label}: {m}'))
    return errs


def serve_engines(port, predictor, engines, device, card, label,
                  heads=((17, 5), (19, 8))):
    """``engines`` ({engine: its kernel, or None}) each on ``predictor``'s
    model: fields equal to the module graph's (TF32 off), the main path's
    requests (:func:`serve`, fields of ``heads``) with the engine's kernel
    launching FORWARD_LAUNCHES times per forward and no other backbone
    kernel. Returns ({kernel: launches}, {engine: its predictor})."""
    from openpifpaf_tpu_torch.predictor import Predictor

    image = test_image(device)
    with no_tf32(), torch.inference_mode():
        ref = predictor._forward(image)
    launches, predictors = {}, {}
    for engine, kernel in engines.items():
        p = Predictor(model=predictor.model, device=device,
                      backbone_engine=engine)
        predictors[engine] = p
        with no_tf32(), torch.inference_mode():
            errs = compare_fields(p._forward(image), ref, f'{label} {engine}',
                                  **ENGINE_TOL)
        log(f'{label} {engine}: fields vs module graph, max abs err per head '
            f'{errs} (TF32 off, rtol/atol {ENGINE_TOL["rtol"]})')
        reset_launches(port)
        forwards = serve(p, make_requests(), card, f'{label} {engine}',
                         heads=heads)
        counts = read_launches(port)
        for name in ('depthwise_conv', 'shuffle_block', 'shuffle_branch2'):
            want = FORWARD_LAUNCHES * forwards if name == kernel else 0
            if counts[name] != want:
                raise AssertionError(f'{label} {engine}: {counts[name]} '
                                     f'{name} launches in {forwards} '
                                     f'forwards, want {want}')
        if kernel is not None:
            launches[kernel] = counts[kernel]
        log(f'{label} {engine}: launches {counts} in {forwards} forwards')
    return launches, predictors


def phase_engines(port, predictor, device, card):
    """Each backbone engine on the module path's model and requests;
    returns {kernel name: launches in its engine's run} and the engines'
    predictors."""
    from openpifpaf_tpu_torch.predictor import Predictor

    image = test_image(device)
    with no_tf32(), torch.inference_mode():
        ref = predictor._forward(image)
    launches, engine_predictors = serve_engines(
        port, predictor, {'dwpallas': 'depthwise_conv',
                          'pallas': 'shuffle_block', 'folded': None},
        device, card, 'engine')
    predictors = {'module graph': predictor, **engine_predictors}

    p16 = Predictor(model=predictor.model, device=device,
                    backbone_engine='pallas', bf16=True)
    x = image.permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    with no_tf32(), torch.inference_mode():
        pairs = list(zip(p16._forward(image), ref))
        pairs.append((p16._backbone(x).float(), predictor.model.base_net(x)))
    for what, (o, r) in zip(('cif', 'caf', 'features'), pairs):
        if not bool(torch.isfinite(o).all()):
            raise AssertionError(f'bf16 pallas: {what} not finite')
        err = float((o - r).abs().max())
        rel = err / float(r.abs().max())
        if not rel <= BF16_FIELD_RTOL:
            raise AssertionError(f'bf16 pallas: {what} error {rel} of the '
                                 f'largest value, want <= {BF16_FIELD_RTOL}')
        log(f'engine pallas bf16: {what} max abs err {err} = {rel:.3g} of '
            f'the largest float32 value (tol {BF16_FIELD_RTOL})')
    serve(p16, make_requests()[:1], card, 'engine pallas bf16')
    predictors['pallas bf16'] = p16
    return launches, predictors


def phase_branch2(port, predictor, device, card):
    """``build_mosaic_forward`` on the folded k16 backbone against the
    module graph's features; returns the branch2 launches."""
    forward = port.block_cuda.build_mosaic_forward(
        port.fused_inference.fold_shufflenet(predictor.model.base_net),
        dtype=torch.float32)
    x = test_image(device).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    with no_tf32(), torch.inference_mode():
        ref = predictor.model.base_net(x)
        reset_launches(port)
        out = forward(x)
        launches = read_launches(port)['shuffle_branch2']
    if launches != FORWARD_LAUNCHES:
        raise AssertionError(f'branch2 path: {launches} launches, want '
                             f'{FORWARD_LAUNCHES}')
    err = compare_fields([out], [ref], 'branch2 path', **ENGINE_TOL)[0]
    log(f'branch2 path: {launches} launches, features vs module graph max '
        f'abs err {err} (TF32 off) [{card}]')
    return launches


def phase_profile(predictors, device, card):
    """Batch-1 forward of each engine on FORWARD_HW: CUDA-event time (TF32 as
    PyTorch defaults it) and, from one profiled forward, device time,
    device ops and BatchNorm kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    image = test_image(device)
    for name, p in predictors.items():
        def forward():
            return p._forward(image)

        with torch.inference_mode():
            ms = cuda_ms(forward, 10)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                forward()
                torch.cuda.synchronize()
        ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in ops) / 1e3
        bn = [e for e in ops if 'bn_' in e.name or 'batch_norm' in e.name
              or 'batchnorm' in e.name.lower()]
        bn_ms = sum(e.time_range.elapsed_us() for e in bn) / 1e3
        log(f'forward {name}, batch 1, {FORWARD_HW}: {ms:.3f} ms (CUDA '
            f'events, 10 reps), device time {busy:.3f} ms in {len(ops)} '
            f'device ops, {len(bn)} BatchNorm kernels ({bn_ms:.3f} ms) '
            f'[{card}]')
        kinds = {}
        for e in bn:
            kinds[e.name[:80]] = kinds.get(e.name[:80], 0) + 1
        log(f'forward {name}: BatchNorm kernels by name {kinds}')


#: the lab kernels' sources and their kernels' names there
LAB_SYMBOLS = {'lab_interleave': ('mosaic_lab.cu', 'interleave_kernel'),
               'lab_dw_valid': ('depthwise.cu', 'depthwise_kernel'),
               'lab_branch2': ('shuffle_block.cu', 'shuffle_block_kernel')}


def phase_lab_kernels(port, device, card):
    """Each lab kernel against its plain version at the lab's three stage
    shapes, float32 and bfloat16, TF32 off, with its launch plan, its
    device time alone and the library call's (``torch.profiler``); returns
    {name: [row, ...]}."""
    from openpifpaf_tpu_torch.lab.timing import device_ms
    from torch_port_helpers import lab_kernel_inputs

    lab = port.lab_kernels
    kernels = {
        # (kernel, plain version, one PyTorch call of the same function)
        'lab_interleave': (lab.lane_interleave, lab.lane_interleave_plain,
                           lab.lane_interleave_plain),
        'lab_dw_valid': (lab.dw_valid, lab.dw_valid_plain,
                         lambda x, wt: F.conv2d(x, wt, groups=x.shape[1])),
        'lab_branch2': (lab.branch2, lab.branch2_plain, None),
    }
    results = {}
    with no_tf32():
        for name, (call, plain, library) in kernels.items():
            results[name] = []
            symbol = LAB_SYMBOLS[name][1]
            for dtype in (torch.float32, torch.bfloat16):
                for i, (stage, (h, w, c)) in enumerate(
                        port.mosaic_lab.STAGES.items()):
                    args = lab_kernel_inputs(name, h, w, c, dtype=dtype,
                                             device=device, seed=i)
                    row = compare_and_time(
                        name, f'{stage} {(h, w, c)} {str(dtype)[6:]}', call,
                        plain, library, args, {}, dtype,
                        lambda ref: LAB_F32_RTOL * float(ref.abs().max()),
                        card)
                    # the kernel's own time, without the wrapper's host time
                    row['device_ms'] = device_ms(
                        functools.partial(call, *args), 10, symbol)
                    row['library_device_ms'] = None if library is None \
                        else device_ms(functools.partial(library, *args), 10)
                    results[name].append(row)
                    log(f'{name} {row["case"]}: plan '
                        f'{launch_plan(port, name, args, {})}; device time '
                        f'alone {fmt_ms(row["device_ms"])}, library device '
                        f'{fmt_ms(row["library_device_ms"])} [{card}]')
    return results


def phase_lab(port, card):
    """The lab's entry point on its three kernels, every launch count set
    to 0 just before and read just after; returns the lab kernels'
    launches."""
    reset_launches(port)
    results = port.mosaic_lab.main(['interleave', 'dw', 'branch2'])
    counts = read_launches(port)
    lab_names = list(port.lab_kernels.LAUNCHES)
    for name, n in counts.items():
        if (n == 0) == (name in lab_names):
            raise AssertionError(f'lab run: {n} launches of {name}')
    if len(results) != 3 * len(port.mosaic_lab.STAGES):
        raise AssertionError(f'lab run: {len(results)} results')
    for r in results:
        if not (r['kernel_s'] > 0 and r['library_s'] > 0):
            raise AssertionError(f'lab run: no time in {r}')
        if r['op'] == 'branch2' and not r['rel_diff'] <= BF16_RTOL:
            raise AssertionError(f'lab run: branch2 kernel vs plain {r}')
    log(f'lab entry point: launches {counts}')
    return {name: counts[name] for name in lab_names}


#: the training phase: the JAX defaults (batch 8, 385 px crops) on a
#: synthetic COCO keypoint set of TRAIN_IMAGES images made from TRAIN_SEED
TRAIN_BATCH = 8
TRAIN_EDGE = 385
TRAIN_IMAGES = 80
TRAIN_IMAGE_HW = (427, 569)
TRAIN_SEED = 0
TRAIN_STEPS = 4
#: one step on the card (float32, TF32 off) against the same step on the
#: CPU in float64, with the CPU's float32 step as the measure of float32's
#: own error: the loss within rtol 1e-4 and each component within 1e-4 of
#: the loss; per tensor (parameters, BatchNorm buffers, EMA), the card's
#: L2 error at most 3x the CPU float32 step's plus 5% of the tensor's
#: update plus float32's rounding of the tensor (2.4e-7 of its L2 norm);
#: over each kind, the card's error at most 5% of the update (L2). On an
#: NVIDIA H100 80GB HBM3 (700 W) the card's error over the parameters
#: measured 0.9% of the update, the CPU float32 step's 8.4%.
STEP_LOSS_RTOL = 1e-4
STEP_NOISE_FACTOR = 3.0
#: the step comparisons against the CPU run on the first STEP_IMAGES
#: images of their batch (for a tracking batch, the first STEP_IMAGES
#: pairs): the CPU's float64 step of the full-width model takes most of
#: their time
STEP_IMAGES = 1
STEP_UPDATE_RTOL = 0.05
STEP_ROUNDING = 2.4e-7
#: overfitting one batch for 40 steps (SGD, lr 1e-3, no warm-up): the
#: mean of the last 5 losses at most 0.7 of the first and 0.9 of the
#: second (this phase on the CPU at 97 px, batch 2: 0.444 and 0.727)
OVERFIT_STEPS = 40
OVERFIT_MAX_FIRST = 0.7
OVERFIT_MAX_SECOND = 0.9


def train_flags(data, out, *extra, prefix='cocokp'):
    """``train.main``'s flags for a run on ``data`` at the JAX defaults;
    ``prefix`` names the data module's flags."""
    ann_file, image_dir = data
    return ['--dataset', 'cocokp', '--basenet', 'shufflenetv2k16',
            f'--{prefix}-train-annotations', ann_file,
            f'--{prefix}-val-annotations', ann_file,
            f'--{prefix}-train-image-dir', image_dir,
            f'--{prefix}-val-image-dir', image_dir,
            f'--{prefix}-square-edge', str(TRAIN_EDGE),
            '--batch-size', str(TRAIN_BATCH), '--epochs', '1',
            '--train-batches', str(TRAIN_STEPS), '--val-batches', '1',
            '--log-interval', '1', '--seed', str(TRAIN_SEED),
            '--output', out, *extra]


def train_batch(data):
    """One batch of the port's CocoKp train pipeline (augmentation on),
    its head metas and the k16 model at full width (random, seeded)."""
    from openpifpaf_tpu_torch.models.factory import Factory
    from openpifpaf_tpu_torch.plugins.coco.cocokp import CocoKp

    ann_file, image_dir = data
    datamodule = CocoKp(train_annotations=ann_file, train_image_dir=image_dir,
                        square_edge=TRAIN_EDGE, batch_size=TRAIN_BATCH)
    model = Factory().from_scratch(
        datamodule.head_metas,
        generator=torch.Generator().manual_seed(TRAIN_SEED))
    np.random.seed(TRAIN_SEED)
    images, targets, _ = next(iter(datamodule.train_loader()))
    return images, targets, datamodule.head_metas, model


def make_trainer(model, metas, device, **flags):
    from openpifpaf_tpu_torch.training import losses, optimize
    from openpifpaf_tpu_torch.training.trainer import Trainer
    from torch_port_helpers import optimizer_args

    optimizer, schedule = optimize.factory_optimizer(
        optimizer_args(**flags), training_batches_per_epoch=1)
    return Trainer(model, losses.Factory().factory(metas), optimizer,
                   schedule, 'unused', device=device)


def step_state(trainer):
    """(state dict, EMA by name) of a trainer, in float64 on the CPU."""
    state = {k: v.detach().cpu().double()
             for k, v in trainer.model.state_dict().items()}
    ema = {n: e.detach().cpu().double() for (n, _), e in
           zip(trainer.model.named_parameters(), trainer.ema)}
    return state, ema


def compare_step(label, names, card_step, cpu32, cpu64, start):
    """The card's tensors against the float64 step (see STEP_*); returns
    the card's and the CPU float32 step's relative L2 error over
    ``names`` and the worst tensor's share of its allowance."""
    worst = (-1.0, '')
    err = {'card': 0.0, 'cpu32': 0.0}
    update = 0.0
    for n in names:
        ref = cpu64[n]
        e_card = float((card_step[n] - ref).norm())
        e_cpu = float((cpu32[n] - ref).norm())
        u = float((ref - start[n]).norm())
        allowed = (STEP_NOISE_FACTOR * e_cpu + STEP_UPDATE_RTOL * u
                   + STEP_ROUNDING * float(ref.norm()))
        worst = max(worst, (e_card / allowed if allowed else
                            float('inf') if e_card else 0.0, n))
        err['card'] += e_card ** 2
        err['cpu32'] += e_cpu ** 2
        update += u ** 2
    rel = {k: np.sqrt(v / update) for k, v in err.items()}
    if not (worst[0] <= 1.0 and rel['card'] <= STEP_UPDATE_RTOL):
        raise AssertionError(
            f'{label} on the card vs the CPU float64 step: '
            f'{worst[1]} at {worst[0]:.3f} of its allowance, {rel["card"]:.3g} '
            f'of the update over all (CPU float32: {rel["cpu32"]:.3g})')
    return rel, worst


def phase_train_step(batch, device, card, label='train step (a)'):
    """(a) One train step of the full-width model of ``batch`` on the
    first STEP_IMAGES images (or pairs) of its batch on the card against
    the same step on the CPU in float64 and float32 (TF32 off): losses,
    parameters, BatchNorm buffers and EMA."""
    import copy

    images, targets, metas, model = batch
    per_target = images.shape[0] // targets[0].shape[0]
    images = images[:STEP_IMAGES * per_target]
    targets = tuple(t[:STEP_IMAGES] for t in targets)
    start = {k: v.detach().double() for k, v in model.state_dict().items()}
    results = {}
    for name, dev, dtype in (('card', device, torch.float32),
                             ('cpu32', torch.device('cpu'), torch.float32),
                             ('cpu64', torch.device('cpu'), torch.float64)):
        trainer = make_trainer(copy.deepcopy(model).to(dtype), metas, dev,
                               lr=1e-3, lr_warm_up_factor=1.0)
        t0 = time.perf_counter()
        with no_tf32():
            loss, head_losses = trainer.train_step(
                torch.from_numpy(images).to(dev, dtype),
                tuple(torch.from_numpy(t).to(dev, dtype) for t in targets))
        results[name] = (float(loss), [float(h) for h in head_losses],
                         *step_state(trainer), time.perf_counter() - t0)
    loss, heads, state, ema, card_s = results['card']
    ref_loss, ref_heads, ref_state, ref_ema, cpu64_s = results['cpu64']
    _, _, cpu_state, cpu_ema, cpu32_s = results['cpu32']
    head_err = max(abs(a - b) for a, b in zip(heads, ref_heads))
    if not (np.isfinite(loss)
            and abs(loss - ref_loss) <= STEP_LOSS_RTOL * abs(ref_loss)
            and head_err <= STEP_LOSS_RTOL * abs(ref_loss)):
        raise AssertionError(f'{label} losses {loss} {heads} on the '
                             f'card, {ref_loss} {ref_heads} on the CPU')
    params = [n for n, _ in model.named_parameters()]
    buffers = [n for n in start if n not in params
               and not n.endswith('num_batches_tracked')]
    for kind, names, ours, cpu32, cpu64 in (
            ('parameters', params, state, cpu_state, ref_state),
            ('BatchNorm buffers', buffers, state, cpu_state, ref_state),
            ('EMA', params, ema, cpu_ema, ref_ema)):
        rel, worst = compare_step(f'{label} {kind}', names, ours, cpu32,
                                  cpu64, start)
        log(f'{label} {kind}: error against the CPU float64 step '
            f'{rel["card"]:.3e} of the update (L2) on the card, '
            f'{rel["cpu32"]:.3e} for the CPU float32 step; worst tensor '
            f'{worst[1]} at {worst[0]:.3f} of its allowance')
    log(f'{label}: {images.shape[0]} images of {images.shape[1]} px: loss '
        f'{loss} on the card, {ref_loss} in float64 '
        f'on the CPU, head losses within {head_err:.3g}; first step '
        f'{card_s * 1e3:.1f} ms on the card, {cpu32_s:.1f} s (float32) and '
        f'{cpu64_s:.1f} s (float64) on the CPU ({torch.get_num_threads()} '
        f'threads) [{card}]')


def timed_train_steps(trainer_cls, events):
    """Wrap ``trainer_cls.train_step`` to record CUDA events around each
    step; returns the original method."""
    original = trainer_cls.train_step

    def train_step(self, *args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = original(self, *args, **kwargs)
        end.record()
        events.append((start, end))
        return out

    trainer_cls.train_step = train_step
    return original


def read_train_log(path):
    with open(path) as f:
        lines = [json.loads(line) for line in f]
    train = [line for line in lines if line.get('type') == 'train']
    val = [line for line in lines if line.get('type') == 'val-epoch']
    return train, val


def train_run(argv, out, label, card):
    """``train.main(argv)`` in-process, writing ``out``: checkpoints
    written, every loss finite; warm step time (CUDA events), images per
    second, peak memory and the loader's share of the wall time. Returns
    the trainer."""
    from openpifpaf_tpu_torch import train
    from openpifpaf_tpu_torch.training.trainer import Trainer

    os.makedirs(os.path.dirname(out))
    events = []
    original = timed_train_steps(Trainer, events)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        trainer = train.main(argv)
    finally:
        Trainer.train_step = original
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - before
    for suffix in ('.epoch000', '.epoch001', ''):
        for ext in ('.json', '.pt'):
            if not os.path.exists(out + suffix + ext):
                raise AssertionError(f'{label}: no {out + suffix + ext}')
    train_lines, val_lines = read_train_log(out + '.log')
    losses = [line['loss'] for line in train_lines] + \
        [line['loss'] for line in val_lines]
    if len(train_lines) != TRAIN_STEPS or len(val_lines) != 1 \
            or not np.all(np.isfinite(losses)):
        raise AssertionError(f'{label}: {len(train_lines)} train lines, '
                             f'{len(val_lines)} val lines, losses '
                             f'{losses}')
    if len(events) != TRAIN_STEPS:
        raise AssertionError(f'{label}: {len(events)} timed steps')
    # warm: the steps after the first (cuDNN picks its algorithms)
    step_ms = [s.elapsed_time(e) for s, e in events][1:]
    median = float(np.median(step_ms))
    warm = train_lines[1:]
    data_s = sum(line['data_time'] for line in warm)
    time_s = sum(line['time'] for line in warm)
    log(f'{label}: warm step {median:.2f} ms median '
        f'(min {min(step_ms):.2f}, max {max(step_ms):.2f} over '
        f'{len(step_ms)} steps, CUDA events), '
        f'{TRAIN_BATCH / median * 1e3:.1f} images/s on the device '
        f'timeline, {TRAIN_BATCH * len(warm) / time_s:.1f} images/s '
        f'of wall time in the loop (loader included), loader share '
        f'{data_s / time_s:.3f} (data_time {data_s:.3f} s of '
        f'{time_s:.3f} s), peak memory {peak / 2 ** 30:.2f} GiB above '
        f'the {before / 2 ** 30:.2f} GiB held before the run; first '
        f'step {train_lines[0]["time"]:.3f} s, losses '
        f'{[round(x, 1) for x in losses]}, whole run {wall:.1f} s '
        f'[{card}]')
    return trainer


def phase_train_runs(data, directory, card):
    """(b) ``train.main`` in-process in float32, ``--bf16`` and
    ``--remat`` (:func:`train_run`). Returns the float32 run's output and
    trainer."""
    runs = {}
    for label, extra in (('float32', ()), ('bf16', ('--bf16',)),
                         ('remat', ('--remat',))):
        out = os.path.join(directory, label, 'model')
        runs[label] = (out, train_run(train_flags(data, out, *extra), out,
                                      f'train run (b) {label}', card))
    return runs['float32']


def profile_train_step(trainer, batch, label, card):
    """One more step of ``trainer`` on ``batch`` (images, targets, ...)
    under ``torch.profiler``: device ops, stream syncs and device busy ms
    against the step's CUDA-event time, and its peak memory."""
    images, targets = batch[:2]
    device = trainer.device
    images = torch.from_numpy(images).to(device)
    targets = tuple(torch.from_numpy(t).to(device) for t in targets)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    start.record()
    trainer.train_step(images, targets)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end)
    peak = torch.cuda.max_memory_allocated() - before
    ops, syncs, busy = decode_profile(
        lambda: trainer.train_step(images, targets))
    log(f'{label}, one step outside the run: {step_ms:.2f} ms (CUDA '
        f'events), peak memory {peak / 2 ** 30:.2f} GiB above the '
        f'{before / 2 ** 30:.2f} GiB held; a profiled step: {ops} device '
        f'ops, {syncs} stream syncs, device busy {busy:.2f} ms [{card}]')


def phase_serve_checkpoint(port, out, trainer, device, card):
    """(c) The float32 run's checkpoint through
    ``Predictor(checkpoint=...)`` on the card: the trainer's EMA weights,
    and one request with its fields checked as the main path's are."""
    from openpifpaf_tpu_torch.predictor import Predictor

    predictor = Predictor(checkpoint=out, device=device)
    written = trainer.ema_state_dict()
    for name, value in predictor.model.state_dict().items():
        if not torch.equal(value.cpu(), written[name]):
            raise AssertionError(f'checkpoint {name} differs from the '
                                 "trainer's EMA")
    reset_launches(port)
    serve(predictor, make_requests()[:1], card, 'trained checkpoint')
    launches = read_launches(port)
    if launches['cifhr_accumulate'] == 0:
        raise AssertionError('serving the checkpoint launched no CifHr '
                             'kernel')
    log(f'serve (c): the checkpoint holds the EMA weights; '
        f'{launches["cifhr_accumulate"]} CifHr kernel launches')


def phase_overfit(batch, device, card):
    """(d) 40 steps on one fixed batch with warm-up off: the loss must
    fall (OVERFIT_MAX_FIRST, OVERFIT_MAX_SECOND)."""
    import copy

    images, targets, metas, model = batch
    trainer = make_trainer(copy.deepcopy(model), metas, device, lr=1e-3,
                           lr_warm_up_factor=1.0)
    images = torch.from_numpy(images).to(device)
    targets = tuple(torch.from_numpy(t).to(device) for t in targets)
    history = [float(trainer.train_step(images, targets)[0])
               for _ in range(OVERFIT_STEPS)]
    last = float(np.mean(history[-5:]))
    if not (np.all(np.isfinite(history))
            and last <= OVERFIT_MAX_FIRST * history[0]
            and last <= OVERFIT_MAX_SECOND * history[1]):
        raise AssertionError(f'overfit: losses {history}')
    log(f'overfit (d): loss {history[0]:.1f} -> {history[1]:.1f} -> '
        f'{last:.1f} (mean of the last 5 of {OVERFIT_STEPS}; '
        f'{last / history[0]:.3f} of the first, {last / history[1]:.3f} of '
        f'the second) [{card}]')
    log(f'overfit (d) losses: {[round(x, 1) for x in history]}')


def phase_train(port, device, card):
    """The training path: a synthetic COCO set, then (a)-(d)."""
    import tempfile
    from torch_port_helpers import write_synthetic_coco

    # the trainer's JSON lines go to each run's log file, not to stdout
    # (train.main's logging.basicConfig does nothing once root has a
    # handler)
    root = logging.getLogger('')
    root.setLevel(logging.INFO)
    root.addHandler(logging.NullHandler())
    with tempfile.TemporaryDirectory() as directory:
        data = write_synthetic_coco(os.path.join(directory, 'coco'),
                                    n_images=TRAIN_IMAGES,
                                    image_hw=TRAIN_IMAGE_HW, seed=TRAIN_SEED)
        batch = train_batch(data)
        phase_train_step(batch, device, card)
        out, trainer = phase_train_runs(data, directory, card)
        phase_serve_checkpoint(port, out, trainer, device, card)
        profile_train_step(trainer, batch, 'train run (b) float32', card)
        phase_overfit(batch, device, card)


#: phase 12: every backbone's float32 forward on the card against the CPU
#: (TF32 off) at this image size, within this share of its largest value
BACKBONE_HW = (129, 161)
BACKBONE_RTOL = 1e-4
#: phase 12c: the eval CLI on a synthetic COCO set of EVAL_IMAGES images of
#: TRAIN_IMAGE_HW made from seed 0, at the JAX default long edge
EVAL_IMAGES = 4
EVAL_LONG_EDGE = 641


def phase_backbones(device, card):
    """(a) Every ``BASE_FACTORIES`` entry at full width, and a group-norm
    and an instance-norm k16: one float32 forward of the backbone on the
    card and on the CPU, with the same weights (seed 0), TF32 off."""
    import copy
    from openpifpaf_tpu_torch.models import factory as models_factory

    image = torch.from_numpy(np.random.RandomState(3).randn(
        1, 3, *BACKBONE_HW).astype(np.float32)).contiguous(
            memory_format=torch.channels_last)
    options = models_factory.SHUFFLENETV2K_OPTIONS
    cases = [(name, 'batch') for name in sorted(models_factory.BASE_FACTORIES)]
    cases += [('shufflenetv2k16', 'group'), ('shufflenetv2k16', 'instance')]
    for name, norm in cases:
        saved = dict(options)
        options['norm'] = norm
        try:
            net = models_factory.BASE_FACTORIES[name]()
        finally:
            options.update(saved)
        models_factory.init_like_flax(net, torch.Generator().manual_seed(0))
        net = net.eval().to(memory_format=torch.channels_last)
        on_card = copy.deepcopy(net).to(device)
        with no_tf32(), torch.inference_mode():
            ref = net(image)
            out = on_card(image.to(device)).cpu()
        del on_card
        err = float((out - ref).abs().max())
        scale = float(ref.abs().max())
        if not (bool(torch.isfinite(out).all()) and scale > 0
                and err <= BACKBONE_RTOL * scale):
            raise AssertionError(f'backbone {name} ({norm} norm): error '
                                 f'{err} of largest value {scale}')
        log(f'backbone {name} ({norm} norm): features {tuple(out.shape)}, '
            f'stride {net.stride}, out_features {net.out_features}, max abs '
            f'err {err:.3g} = {err / scale:.3g} of the largest value (tol '
            f'{BACKBONE_RTOL}, TF32 off) [{card}]')


def phase_resnet50(port, device, card):
    """(b) resnet50 with the cocokp heads at the JAX defaults (stride 16,
    2048 features; random, seed 0) serving the main path's requests on the
    module graph (``'auto'``), with the CifHr launches read around them;
    then the batch-1 forward profile in float32 and bf16. Returns the model
    and the CifHr launches."""
    from openpifpaf_tpu_torch.models.factory import Factory
    from openpifpaf_tpu_torch.plugins.coco.constants import cocokp_head_metas
    from openpifpaf_tpu_torch.predictor import Predictor

    model = Factory('resnet50').from_scratch(
        cocokp_head_metas(), generator=torch.Generator().manual_seed(0))
    base = model.base_net
    if (type(base).__name__, base.stride, base.out_features) != \
            ('Resnet', 16, 2048):
        raise AssertionError(f'resnet50: {base.stride} {base.out_features}')
    predictor = Predictor(model=model, device=device)
    if predictor._backbone is not None:
        raise AssertionError("resnet50: 'auto' did not pick the module graph")
    check_fields_against_cpu(predictor, device)
    reset_launches(port)
    serve(predictor, make_requests(), card, 'resnet50')
    launches = read_launches(port)['cifhr_accumulate']
    if launches == 0:
        raise AssertionError('resnet50 serving launched no CifHr kernel')
    log(f'resnet50: {launches} CifHr kernel launches')

    p16 = Predictor(model=model, device=device, bf16=True)
    image = test_image(device)
    with torch.inference_mode():
        pairs = zip(p16._forward(image), predictor._forward(image))
        for what, (o, r) in zip(('cif', 'caf'), pairs):
            rel = float((o - r).abs().max()) / float(r.abs().max())
            if not (bool(torch.isfinite(o).all()) and rel <= BF16_FIELD_RTOL):
                raise AssertionError(f'resnet50 bf16: {what} error {rel}')
            log(f'resnet50 bf16: {what} max abs err {rel:.3g} of the largest '
                f'float32 value (tol {BF16_FIELD_RTOL})')
    phase_profile({'resnet50': predictor, 'resnet50 bf16': p16}, device,
                  card)
    return model, launches


def _port_run(module, *args):
    """``python -m module args`` of this checkout; raises on failure."""
    done = subprocess.run(
        [sys.executable, '-m', module, *args], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=600)
    if done.returncode != 0:
        raise AssertionError(f'{module} exited {done.returncode}: '
                             f'{done.stderr[-3000:]}')
    return done


def save_checkpoint(path, model, base_name):
    """``model`` as a checkpoint of the port's trainer at ``path``."""
    from openpifpaf_tpu_torch import __version__
    from openpifpaf_tpu_torch.models import factory as models_factory
    from openpifpaf_tpu_torch.training import checkpoint

    checkpoint.save(path, state_dict=model.state_dict(), meta={
        'base_name': base_name, 'epoch': 0, 'version': __version__,
        'backbone_options': {
            'shufflenetv2k': dict(models_factory.SHUFFLENETV2K_OPTIONS),
            'resnet': dict(models_factory.RESNET_OPTIONS)},
        'head_metas': [checkpoint.headmeta_to_dict(m)
                       for m in model.head_metas]})


def ground_truth_stats(metric, ann_file):
    """The stats of the keypoint ``metric`` fed the ground truth of
    ``ann_file`` as predictions (score 1)."""
    from openpifpaf_tpu_torch.annotation import Annotation
    from openpifpaf_tpu_torch.plugins.coco import constants

    with open(ann_file) as f:
        data = json.load(f)
    for image in data['images']:
        metric.accumulate([
            Annotation(constants.COCO_KEYPOINTS,
                       constants.COCO_PERSON_SKELETON).set(
                np.asarray(a['keypoints'], np.float32).reshape(17, 3),
                fixed_score=1.0, fixed_bbox=a['bbox'])
            for a in data['annotations'] if a['image_id'] == image['id']],
            {'image_id': image['id']})
    return metric.stats()['stats']


def phase_eval(model, card):
    """(c) ``python -m openpifpaf_tpu_torch.eval`` on the card over a
    synthetic COCO set with the resnet50 saved as a checkpoint of the port;
    the ground truth as predictions through ``metric.Coco`` (AP 1.0); one
    ``benchmark.py`` entry over the same checkpoint."""
    import tempfile
    from openpifpaf_tpu_torch.plugins.coco.cocokp import CocoKp
    from torch_port_helpers import restored_statics, write_synthetic_coco

    with tempfile.TemporaryDirectory() as directory:
        ann_file, image_dir = write_synthetic_coco(
            os.path.join(directory, 'coco'), n_images=EVAL_IMAGES,
            image_hw=TRAIN_IMAGE_HW, seed=0)
        ckpt = os.path.join(directory, 'resnet50')
        save_checkpoint(ckpt, model, 'resnet50')
        with restored_statics(CocoKp):
            CocoKp.eval_annotations = ann_file
            CocoKp.eval_image_dir = image_dir
            datamodule = CocoKp()
            n_images = len(datamodule.eval_loader().dataset)
            metric = datamodule.metrics()[0]
        flags = ['--dataset', 'cocokp', '--cocokp-val-annotations', ann_file,
                 '--cocokp-val-image-dir', image_dir, '--coco-eval-long-edge',
                 str(EVAL_LONG_EDGE), '--eval-loader-warmup', '0']
        out = os.path.join(directory, 'eval')
        t0 = time.perf_counter()
        _port_run('openpifpaf_tpu_torch.eval', *flags, '--checkpoint', ckpt,
                  '--output', out)
        wall = time.perf_counter() - t0
        with open(out + '.stats.json') as f:
            stats = json.load(f)
        if not (len(stats['stats']) == 10
                and np.all(np.isfinite(stats['stats']))
                and stats['n_images'] == n_images > 0
                and stats['nn_time'] > 0 and stats['decoder_time'] > 0
                and stats['file_size'] == os.path.getsize(ckpt + '.pt')):
            raise AssertionError(f'eval stats {stats}, {n_images} images')
        per_image = {k: stats[k] / n_images * 1e3
                     for k in ('total_time', 'nn_time', 'decoder_time')}
        log(f'eval (c): resnet50 over {n_images} images at long edge '
            f'{EVAL_LONG_EDGE}: per image total {per_image["total_time"]:.2f} '
            f'ms, nn {per_image["nn_time"]:.2f} ms, decoder '
            f'{per_image["decoder_time"]:.2f} ms (the first image included); '
            f'stats {[round(v, 4) for v in stats["stats"]]} (random '
            f'weights); whole command {wall:.1f} s [{card}]')

        gt_stats = ground_truth_stats(metric, ann_file)
        if gt_stats[0] != 1.0:
            raise AssertionError(f'ground truth as predictions: {gt_stats}')
        log(f'eval (c): the ground truth as predictions gives AP '
            f'{gt_stats[0]}, AR {gt_stats[5]}')

        bench = os.path.join(directory, 'bench')
        done = _port_run('openpifpaf_tpu_torch.benchmark', '--checkpoints',
                         ckpt, '--output', bench, '--n-images', '2', *flags)
        with open(os.path.join(bench, ckpt.replace('/', '-')
                               + '.eval-cocokp.stats.json')) as f:
            bench_stats = json.load(f)
        if bench_stats['n_images'] != 2:
            raise AssertionError(f'benchmark stats {bench_stats}')
        log('eval (c): benchmark.py, one entry over 2 images:')
        log(done.stdout.strip())


def phase_other_backbones(port, device, card):
    """Phase 12: (a)-(c); returns the CifHr launches of (b)."""
    phase_backbones(device, card)
    model, launches = phase_resnet50(port, device, card)
    phase_eval(model, card)
    return launches


#: phase 13: frames of the tracking forward and of the video CLI
TRACKING_FRAMES = 3
VIDEO_FRAMES = 4
#: tracking fields on the card against the CPU, float32 with TF32 off:
#: max abs error within this share of each head's largest value
TRACKING_RTOL = 1e-4


def tracking_model(metas=None):
    """A full-width tshufflenetv2k16 with ``metas`` (default: the cocokpst
    heads, 17 CIF fields, 19 CAF and 17 TCAF edges), random from seed 0."""
    from openpifpaf_tpu_torch.datasets import factory
    from openpifpaf_tpu_torch.models.factory import Factory
    return Factory('tshufflenetv2k16').from_scratch(
        metas or factory('cocokpst').head_metas,
        generator=torch.Generator().manual_seed(0))


def compare_heads(out, ref, label):
    """Each head's max abs error against ``ref`` (CPU tensors), raising
    beyond TRACKING_RTOL of the head's largest value."""
    errs = []
    for o, r in zip(out, ref):
        scale = float(r.abs().max())
        err = float((o.cpu() - r).abs().max())
        if not (scale > 0.0 and err <= TRACKING_RTOL * scale):
            raise AssertionError(f'{label}: max abs err {err}, largest '
                                 f'value {scale}')
        errs.append(err / scale)
    return errs


def phase_tracking_forward(device, card):
    """13a: the tracking forward of ``Predictor`` on the card against the
    CPU, frame by frame (backbone on the new frame, heads on [new,
    previous]); frame 2's Tcaf must be the heads on [frame 2, frame 1]
    and differ from frame 2 paired with itself."""
    import copy
    from openpifpaf_tpu_torch.predictor import Predictor

    model = tracking_model()
    gpu = Predictor(model=model, device=device)
    cpu = Predictor(model=copy.deepcopy(model), device='cpu')
    rng = np.random.RandomState(4)
    images = [gpu.preprocess(rng.randint(0, 256, IMAGE_HW + (3,),
                                         dtype=np.uint8), [], None)[0]
              for _ in range(TRACKING_FRAMES)]
    nn_ms = []
    with no_tf32():
        for i, image in enumerate(images):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = gpu.fields_batch(image[None])
            end.record()
            torch.cuda.synchronize()
            nn_ms.append(start.elapsed_time(end))
            ref = cpu.fields_batch(image[None])
            want = [(1, 17, 5) + FIELD_HW, (1, 19, 8) + FIELD_HW,
                    (1, 17, 8) + FIELD_HW]
            if [tuple(o.shape) for o in out] != want:
                raise AssertionError(f'tracking fields {out}, want {want}')
            errs = compare_heads(out, ref, f'tracking frame {i}')
            log(f'tracking (13a) frame {i}: fields on the card match the '
                f'CPU (TF32 off), max abs err / largest value cif '
                f'{errs[0]:.2e} caf {errs[1]:.2e} tcaf {errs[2]:.2e}')
        with torch.inference_mode():
            x1, x2 = (torch.from_numpy(gpu._bucket_pad(im[None])).to(device)
                      for im in images[:2])
            f1, f2 = model.backbone(x1), model.backbone(x2)
            paired = model.heads(torch.cat([f2, f1]))[2]
            alone = model.heads(torch.cat([f2, f2]))[2]
        gpu.reset_tracking()
        gpu.fields_batch(images[0][None])
        cached = gpu.fields_batch(images[1][None])[2]
    compare_heads([cached], [paired.cpu()], 'tracking cache')
    d_paired = float((cached - paired).abs().max())
    d_alone = float((cached - alone).abs().max())
    if not d_alone > 10.0 * d_paired:
        raise AssertionError(f"frame 2's Tcaf did not see frame 1: max abs "
                             f'diff {d_paired} to [frame 2, frame 1], '
                             f'{d_alone} to [frame 2, frame 2]')
    log(f'tracking (13a): frame 2\'s Tcaf is the heads on [frame 2, frame '
        f'1] (the cached features; max abs diff {d_paired:.2e}, to frame 2 '
        f'paired with itself {d_alone:.2e}); NN ms per frame (CUDA events, '
        f'TF32 off, the first includes warm-up) '
        f'{[round(t, 3) for t in nn_ms]} [{card}]')


def phase_tracking_golden(cifhr_cuda, device, card):
    """13b: the tracking golden file's frames through the port's tracking
    ``Multi`` (CifCaf and TrackingPose, CifHr 'auto': the kernel) on the
    card: each frame's annotations and track ids against JAX's, the CifHr
    launches per frame; then warm decode ms per frame and, from a profiled
    pass, device ops, stream syncs and device busy time per frame."""
    from torch_port_helpers import GOLDEN_STRIDE, TRACKING_GOLDEN, \
        assert_tracking_frame, port_tracking_decoder, reset_port_track_ids, \
        tracking_golden_fields

    golden = np.load(TRACKING_GOLDEN)
    frames = [[torch.from_numpy(f[None]).to(device) for f in fields]
              for fields in tracking_golden_fields(golden)]

    def sequence(step):
        reset_port_track_ids()
        multi = port_tracking_decoder(GOLDEN_STRIDE)
        return [step(multi, fields) for fields in frames]

    def checked(multi, fields):
        before = cifhr_cuda.LAUNCHES
        anns = multi.batch_decode(fields)[0]
        return anns, cifhr_cuda.LAUNCHES - before

    def timed(multi, fields):
        anns = multi.batch_decode(fields)[0]
        return anns, multi.last_decoder_time * 1e3

    def profiled(multi, fields):
        out = []
        stats = decode_profile(lambda: out.append(
            multi.batch_decode(fields)[0]))
        return out[0], stats

    first = sequence(checked)
    for t, (anns, launches) in enumerate(first):
        assert_tracking_frame(anns, golden[f'frame{t}_poses'],
                              golden[f'frame{t}_ids'], label=f'frame {t}')
        if launches == 0:
            raise AssertionError(f'tracking golden frame {t}: no CifHr '
                                 'kernel launch')
    warm = sequence(timed)
    for t, (anns, _) in enumerate(warm):
        assert_tracking_frame(anns, golden[f'frame{t}_poses'],
                              golden[f'frame{t}_ids'], label=f'frame {t}')
    prof = sequence(profiled)
    for t, ((anns, launches), (_, ms), (_, (ops, syncs, busy))) in \
            enumerate(zip(first, warm, prof)):
        ids = [a.id_ for a in anns if a.id_ is not None]
        log(f'tracking golden (13b) frame {t}: {len(anns)} annotations '
            f'match the JAX decode, track ids {ids}; {launches} CifHr '
            f'kernel launches; decode {ms:.2f} ms (second pass), {ops} '
            f'device ops, {syncs} stream syncs, device busy {busy:.3f} ms '
            f'(profiled pass) [{card}]')


def write_video_frames(directory):
    """VIDEO_FRAMES random JPEGs of IMAGE_HW (seed 5) in ``directory``;
    returns their paths in order."""
    import PIL.Image

    rng = np.random.RandomState(5)
    names = []
    for i in range(VIDEO_FRAMES):
        names.append(os.path.join(directory, f'f{i}.jpg'))
        PIL.Image.fromarray(rng.randint(
            0, 256, IMAGE_HW + (3,), dtype=np.uint8)).save(names[-1])
    return names


def phase_video(port, device, card):
    """13c: ``openpifpaf_tpu_torch.video.main`` (the CLI's entry point) on
    the card with a random tshufflenetv2k16 tracking checkpoint saved by
    the port over VIDEO_FRAMES synthetic JPEGs of IMAGE_HW: one JSON line
    per frame; per-frame NN ms (CUDA events around ``fields_batch``),
    decode ms and peak memory, with the CifHr launches read around the
    run; then a second run with each decode profiled for its device busy
    time. Returns the first run's CifHr launches."""
    import tempfile
    from openpifpaf_tpu_torch import __version__, decoder, video
    from openpifpaf_tpu_torch.predictor import Predictor
    from openpifpaf_tpu_torch.training import checkpoint
    from torch_port_helpers import restored_statics

    model = tracking_model()
    with tempfile.TemporaryDirectory() as directory:
        ckpt = os.path.join(directory, 'tshufflenetv2k16')
        checkpoint.save(ckpt, state_dict=model.state_dict(), meta={
            'base_name': 'tshufflenetv2k16', 'epoch': 0,
            'version': __version__,
            'head_metas': [checkpoint.headmeta_to_dict(m)
                           for m in model.head_metas]})
        names = write_video_frames(directory)

        def run(label, profile):
            out = os.path.join(directory, label + '.jsonl')
            nn_ms, decode = [], []
            fields_batch = Predictor.fields_batch
            batch_decode = decoder.Multi.batch_decode

            def timed_fields(self, image_batch):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fields = fields_batch(self, image_batch)
                end.record()
                torch.cuda.synchronize()
                nn_ms.append(start.elapsed_time(end))
                return fields

            def measured_decode(self, fields):
                if not profile:
                    anns = batch_decode(self, fields)
                    decode.append(self.last_decoder_time * 1e3)
                    return anns
                anns = []
                decode.append(decode_profile(lambda: anns.append(
                    batch_decode(self, fields))))
                return anns[0]

            Predictor.fields_batch = timed_fields
            decoder.Multi.batch_decode = measured_decode
            gc.collect()
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            start = time.perf_counter()
            try:
                with restored_statics(*decoder.DECODERS, decoder.TrackBase):
                    video.main(['--source', ','.join(names), '--checkpoint',
                                ckpt, '--json-output', out, '--quiet'])
            finally:
                Predictor.fields_batch = fields_batch
                decoder.Multi.batch_decode = batch_decode
            wall = time.perf_counter() - start
            peak = torch.cuda.max_memory_allocated() - before
            with open(out) as f:
                lines = [json.loads(line) for line in f]
            if [line['frame'] for line in lines] != \
                    list(range(1, VIDEO_FRAMES + 1)) or any(
                        not isinstance(line['predictions'], list)
                        for line in lines):
                raise AssertionError(f'video {label}: JSON lines {lines}')
            return lines, nn_ms, decode, peak, wall

        reset_launches(port)
        lines, nn_ms, decode_ms, peak, wall = run('timed', False)
        launches = read_launches(port)['cifhr_accumulate']
        if launches == 0:
            raise AssertionError('the video CLI launched no CifHr kernel')
        _, _, profiles, _, _ = run('profiled', True)
    for i, (nn, ms, (ops, syncs, busy)) in enumerate(zip(nn_ms, decode_ms,
                                                         profiles)):
        log(f'video (13c) frame {i + 1}: NN {nn:.3f} ms (CUDA events), '
            f'decode {ms:.2f} ms, {len(lines[i]["predictions"])} '
            f'predictions; profiled run: {ops} device ops, {syncs} stream '
            f'syncs, device busy {busy:.3f} ms = {busy / ms:.3f} of the '
            f'unprofiled decode{" (first frame, warm-up)" if i == 0 else ""}'
            f' [{card}]')
    log(f'video (13c): {VIDEO_FRAMES} JSON lines with frame and predictions;'
        f' {launches} CifHr kernel launches; warm (frames 2-{VIDEO_FRAMES}) '
        f'median NN {np.median(nn_ms[1:]):.3f} ms, decode '
        f'{np.median(decode_ms[1:]):.2f} ms per frame; peak memory '
        f'{peak / 2 ** 30:.3f} GiB above what the process held; whole run '
        f'{wall:.1f} s [{card}]')
    return launches


def phase_tracking(port, device, card):
    """Phase 13: (a)-(c); returns the CifHr launches of (c)."""
    phase_tracking_forward(device, card)
    phase_tracking_golden(port.cifhr_cuda, device, card)
    return phase_video(port, device, card)


@contextlib.contextmanager
def kept_cifhr_calls(cifhr_cuda):
    """Within: the cells and keywords of each ``cifhr_cuda.accumulate``
    call are kept (cloned) in the list this yields."""
    accumulate = cifhr_cuda.accumulate
    calls = []

    def kept(x, y, sigma, w, **kw):
        calls.append(((x.clone(), y.clone(), sigma.clone(), w.clone()), kw))
        return accumulate(x, y, sigma, w, **kw)

    cifhr_cuda.accumulate = kept
    try:
        yield calls
    finally:
        cifhr_cuda.accumulate = accumulate


def check_kept_calls(port, calls, label):
    """The kernel on each kept call's cells against its plain version, bit
    for bit (these launches come after the run's count is read)."""
    shapes = set()
    for i, (cells, kw) in enumerate(calls):
        kernel = port.cifhr_cuda.accumulate(*cells, **kw)
        plain = port.cifhr.accumulate_dense(*cells, **kw)
        if not torch.equal(kernel, plain):
            raise AssertionError(
                f'{label} CifHr call {i} at {tuple(kernel.shape)}: kernel '
                'vs plain not bit-equal, max abs err '
                f'{float((kernel - plain).abs().max())}')
        shapes.add((*kernel.shape, cells[0].shape[1]))
    log(f'{label}: the kernel on the cells of all {len(calls)} CifHr calls '
        'equals its plain version bit for bit at (F, hr_h, hr_w, K) '
        f'{sorted(shapes)}')
    return shapes


#: phase 14: PoseTrack eval over POSETRACK_SEQUENCES synthetic sequences of
#: POSETRACK_FRAMES frames at PoseTrack's usual 720x1280, at the default
#: --posetrack-eval-long-edge (801)
POSETRACK_SEQUENCES = 2
POSETRACK_FRAMES = 4
POSETRACK_HW = (720, 1280)
#: decoder thresholds lowered so that the fields give poses: the eval's
#: posetrack2018 heads do not match the checkpoint's cocokpst heads by
#: (dataset, name), so they are new, initialised from seed 0 (as in the
#: JAX package), with confidences near 0.5 everywhere; at the default
#: seed threshold (0.5) no pose comes out, at 0.1 the seed budget fills
POSETRACK_DECODER_FLAGS = ('--seed-threshold', '0.1', '--keypoint-threshold',
                           '0.01', '--instance-threshold', '0.0')
#: CifHr tiers each decoder runs per frame with these flags: the fast tier,
#: and the crowd tier because the seed budget fills; one launch each
POSETRACK_TIERS = 2


def tracking_train_batch(data):
    """One batch of the port's cocokpst pipeline (augmentation on: 4
    pairs, 8 interleaved frames at 385 px), its head metas and the
    full-width tshufflenetv2k16 (random, seed 0)."""
    from openpifpaf_tpu_torch.datasets import factory
    from openpifpaf_tpu_torch.plugins.coco.cocokp import CocoKp
    from torch_port_helpers import restored_statics

    ann_file, image_dir = data
    with restored_statics(CocoKp):
        CocoKp.train_annotations, CocoKp.train_image_dir = ann_file, image_dir
        CocoKp.square_edge = TRAIN_EDGE
        datamodule = factory('cocokpst')
        datamodule.batch_size = TRAIN_BATCH
        model = tracking_model(datamodule.head_metas)
        np.random.seed(TRAIN_SEED)
        images, targets, metas = next(iter(datamodule.train_loader()))
    if images.shape != (TRAIN_BATCH, TRAIN_EDGE, TRAIN_EDGE, 3) \
            or len(targets) != 3 or len(metas) != TRAIN_BATCH // 2 \
            or any(t.shape[0] != TRAIN_BATCH // 2 for t in targets):
        raise AssertionError(f'cocokpst batch {images.shape}, targets '
                             f'{[t.shape for t in targets]}, {len(metas)} '
                             'metas')
    return images, targets, datamodule.head_metas, model


def phase_tracking_train(data, directory, device, card):
    """14a-b: one cocokpst step on the card against the CPU's
    (:func:`phase_train_step`), then ``train.main --dataset cocokpst
    --basenet tshufflenetv2k16`` at the JAX defaults (:func:`train_run`);
    ``load_shell`` reads its checkpoint as a TrackingShell with the
    trainer's EMA weights. Returns the checkpoint."""
    from openpifpaf_tpu_torch.models.tracking import TrackingShell
    from openpifpaf_tpu_torch.training import checkpoint

    batch = tracking_train_batch(data)
    phase_train_step(batch, device, card, label='tracking train step (14a)')
    out = os.path.join(directory, 'cocokpst', 'model')
    trainer = train_run(train_flags(data, out, '--dataset', 'cocokpst',
                                    '--basenet', 'tshufflenetv2k16'),
                        out, 'tracking train run (14b) float32', card)
    model, meta = checkpoint.load_shell(out)
    written = trainer.ema_state_dict()
    if not (isinstance(model, TrackingShell)
            and meta['base_name'] == 'tshufflenetv2k16'
            and all(torch.equal(v, written[k])
                    for k, v in model.state_dict().items())):
        raise AssertionError(f'load_shell({out}): {type(model).__name__}, '
                             f'{meta["base_name"]}')
    log(f'tracking train run (14b): load_shell reads {out} as a '
        f'TrackingShell with the trainer\'s EMA weights, heads '
        f'{[type(m).__name__ for m in model.head_metas]}')
    profile_train_step(trainer, batch, 'tracking train run (14b) float32',
                       card)
    return out


def phase_posetrack_eval(port, ckpt, directory, card):
    """14c: ``openpifpaf_tpu_torch.eval.main`` (in-process, on the card)
    ``--dataset posetrack2018 --write-predictions`` with 14b's checkpoint
    over synthetic PoseTrack 2018 sequences, at batch 1 and the default
    long edge: per frame the CifHr launches of CifCaf and of TrackingPose
    (read through the launch counter around each decoder), NN ms (CUDA
    events) and each decoder's ms; ``eval_reset`` emitted once, when the
    second sequence's first frame is pulled; the stats and one prediction
    JSON per sequence. Each decoder must launch the kernel once per tier
    it ran, POSETRACK_TIERS times per frame. The cells of every CifHr call
    of the run are kept, and the kernel on them is held bit for bit
    against its plain version at the eval's map shape. Returns the run's
    CifHr launches (the comparison's launches come after and are not
    counted)."""
    from openpifpaf_tpu_torch import decoder, eval_cli
    from openpifpaf_tpu_torch.plugins.coco.cocokp import CocoKp
    from openpifpaf_tpu_torch.plugins.posetrack.cocokpst import CocoKpSt
    from openpifpaf_tpu_torch.plugins.posetrack.posetrack2017 import \
        Posetrack2017
    from openpifpaf_tpu_torch.plugins.posetrack.posetrack2018 import \
        Posetrack2018
    from openpifpaf_tpu_torch.predictor import Predictor
    from openpifpaf_tpu_torch.signal_ import Signal
    from torch_port_helpers import restored_statics, \
        write_synthetic_posetrack2018

    _, val_glob, root = write_synthetic_posetrack2018(
        os.path.join(directory, 'posetrack'), n_sequences=POSETRACK_SEQUENCES,
        n_frames=POSETRACK_FRAMES, image_hw=POSETRACK_HW, seed=0)
    frames = []
    resets = []
    fields_batch = Predictor.fields_batch
    batch_decode = decoder.Multi.batch_decode
    cifhr_cuda = port.cifhr_cuda

    def timed_fields(self, image_batch):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fields = fields_batch(self, image_batch)
        end.record()
        torch.cuda.synchronize()
        frames.append({'nn_ms': start.elapsed_time(end),
                       'shape': tuple(image_batch.shape)})
        return fields

    def counted(dec):
        inner = dec.batch_decode

        def per_decoder(fields):
            before = cifhr_cuda.LAUNCHES
            out = inner(fields)
            tiers = 1 + len(getattr(dec, 'pose_generator', dec).last_escalated)
            frames[-1][type(dec).__name__] = (
                cifhr_cuda.LAUNCHES - before, dec.last_decoder_time * 1e3,
                tiers)
            return out
        return per_decoder

    def counted_decode(self, fields):
        for dec in self.decoders:
            if 'batch_decode' not in vars(dec):
                dec.batch_decode = counted(dec)
        return batch_decode(self, fields)

    out = os.path.join(directory, 'posetrack-eval')
    subscribers = list(Signal.subscribers.get('eval_reset', []))
    Signal.subscribe('eval_reset', lambda: resets.append(len(frames)))
    Predictor.fields_batch = timed_fields
    decoder.Multi.batch_decode = counted_decode
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(port)
    t0 = time.perf_counter()
    try:
        with kept_cifhr_calls(cifhr_cuda) as calls, \
                restored_statics(*decoder.DECODERS, decoder.TrackBase, CocoKp,
                                 CocoKpSt, Posetrack2018, Posetrack2017,
                                 eval_cli.Evaluator):
            eval_cli.main(['--dataset', 'posetrack2018', '--checkpoint', ckpt,
                           '--posetrack2018-eval-annotations', val_glob,
                           '--posetrack2018-data-root', root,
                           '--write-predictions', '--eval-loader-warmup',
                           '0', '--output', out, *POSETRACK_DECODER_FLAGS])
    finally:
        Predictor.fields_batch = fields_batch
        decoder.Multi.batch_decode = batch_decode
        Signal.subscribers['eval_reset'] = subscribers
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - before
    launches = read_launches(port)['cifhr_accumulate']

    n_frames = POSETRACK_SEQUENCES * POSETRACK_FRAMES
    with open(out + '.stats.json') as f:
        stats = json.load(f)
    files = sorted(os.listdir(out))
    if not (len(frames) == stats['n_images'] == n_frames
            and stats['nn_time'] > 0 and stats['decoder_time'] > 0
            and stats['stats'][0] == n_frames):
        raise AssertionError(f'posetrack eval: {len(frames)} frames, stats '
                             f'{stats}')
    if resets != [POSETRACK_FRAMES]:
        raise AssertionError(f'posetrack eval: eval_reset after frames '
                             f'{resets}, want once after frame '
                             f'{POSETRACK_FRAMES}')
    names = ('CifCaf', 'TrackingPose')
    for i, frame in enumerate(frames):
        got = [frame.get(name, (0, 0, 0)) for name in names]
        if any(g[0] != g[2] or g[2] != POSETRACK_TIERS for g in got):
            raise AssertionError(f'posetrack eval frame {i}: (CifHr '
                                 'launches, ms, tiers) per decoder '
                                 f'{frame}, want {POSETRACK_TIERS} tiers '
                                 'and one launch per tier')
    want = len(names) * POSETRACK_TIERS * n_frames
    if not launches == len(calls) == want:
        raise AssertionError(f'posetrack eval: {launches} CifHr launches, '
                             f'{len(calls)} calls, want {want}')
    check_kept_calls(port, calls, 'posetrack eval (14c)')
    if len(files) != POSETRACK_SEQUENCES:
        raise AssertionError(f'posetrack eval: prediction files {files}')
    predictions = []
    for name in files:
        with open(os.path.join(out, name)) as f:
            data = json.load(f)
        if len(data['images']) != POSETRACK_FRAMES:
            raise AssertionError(f'{name}: {len(data["images"])} images')
        predictions.append(len(data['annotations']))
    for i, frame in enumerate(frames):
        log(f'posetrack eval (14c) frame {i}: image {frame["shape"]}, NN '
            f'{frame["nn_ms"]:.3f} ms (CUDA events); CifCaf '
            f'{frame["CifCaf"][0]} CifHr launches, {frame["CifCaf"][1]:.2f} '
            f'ms; TrackingPose {frame["TrackingPose"][0]} CifHr launches, '
            f'{frame["TrackingPose"][1]:.2f} ms [{card}]')
    per_image = {k: stats[k] / n_frames * 1e3
                 for k in ('total_time', 'nn_time', 'decoder_time')}
    log(f'posetrack eval (14c): {n_frames} frames of {POSETRACK_HW} in '
        f'{POSETRACK_SEQUENCES} sequences, eval_reset once (after frame '
        f'{resets[0]}), {launches} CifHr kernel launches; per frame (stats,'
        f' the first included) total {per_image["total_time"]:.2f} ms, nn '
        f'{per_image["nn_time"]:.2f} ms, decoder '
        f'{per_image["decoder_time"]:.2f} ms; warm (frames 2-) median NN '
        f'{np.median([f["nn_ms"] for f in frames[1:]]):.3f} ms, decode '
        f'{np.median([sum(f[n][1] for n in names) for f in frames[1:]]):.2f}'
        f' ms; {files} with {predictions} predictions (stats '
        f'{stats["stats"]}); peak memory {peak / 2 ** 30:.3f} GiB above '
        f'what the process held; whole command {wall:.1f} s [{card}]')
    return launches


def phase_tracking_training(port, device, card):
    """Phase 14: (a)-(c) on a synthetic COCO set; returns the CifHr
    launches of (c)."""
    import tempfile
    from torch_port_helpers import write_synthetic_coco

    with tempfile.TemporaryDirectory() as directory:
        data = write_synthetic_coco(os.path.join(directory, 'coco'),
                                    n_images=TRAIN_IMAGES,
                                    image_hw=TRAIN_IMAGE_HW, seed=TRAIN_SEED)
        ckpt = phase_tracking_train(data, directory, device, card)
        return phase_posetrack_eval(port, ckpt, directory, card)


#: phase 15: the keypoint plugins. Wholebody's served heads: 133 CIF fields
#: of 5 components and 160 CAF edges of 8 (the decoded layout)
WHOLEBODY_HEADS = ((133, 5), (160, 8))
#: 15b: one wholebody step on the card against the CPU's float64 step at
#: this batch (the run itself takes TRAIN_BATCH)
WHOLEBODY_STEP_BATCH = 2
#: 15d: the eval's synthetic wholebody images (TRAIN_IMAGE_HW, seed 1), at
#: EVAL_LONG_EDGE
WHOLEBODY_EVAL_IMAGES = 2
#: 15e: the other plugins, each served by a random k16 with its heads:
#: (label, data module, flags, CIF fields, CAF edges)
PLUGIN_CASES = (('crowdpose', 'crowdpose', (), 14, 15),
                ('animal', 'animal', (), 20, 20),
                ('apollo 24', 'apollo', (), 24, 49),
                ('apollo 66', 'apollo', ('--apollo-use-66-kps',), 66, 108))
#: 15e: the tracking benchmark wrapper's --crowdpose over this many
#: synthetic CrowdPose images, with the buckets of the JAX package's
#: crowdpose module (min <= crowdIndex < max, the top bucket closed)
CROWDPOSE_IMAGES = 4
CROWDPOSE_BUCKETS = {'easy': (0.0, 0.1), 'medium': (0.1, 0.8),
                     'hard': (0.8, 1.0)}


def phase_wholebody_golden(port, device, card):
    """15a: the port's CifCaf at 133 keypoints on the contested scenes of
    ``tests/golden/torch_wholebody_golden.npz``: JAX's poses within the
    gate, one CifHr launch per tier; the warm batch-1 decode time (median
    of 3 after one) and one profiled decode's device ops, stream syncs and
    busy time; the kernel on every call's cells against its plain
    version."""
    from openpifpaf_tpu_torch.decoder import CifCaf
    from torch_port_helpers import WHOLEBODY_GOLDEN, WHOLEBODY_SEEDS, \
        port_wholebody_metas

    golden = np.load(WHOLEBODY_GOLDEN)
    decoder = CifCaf(*port_wholebody_metas())
    cifhr_cuda = port.cifhr_cuda
    with kept_cifhr_calls(cifhr_cuda) as calls:
        for seed in WHOLEBODY_SEEDS:
            wholebody_golden_scene(decoder, golden, seed, cifhr_cuda,
                                   device, card)
    check_kept_calls(port, calls, 'wholebody golden (15a)')


def wholebody_golden_scene(decoder, golden, seed, cifhr_cuda, device, card):
    """One scene of :func:`phase_wholebody_golden`."""
    from torch_port_helpers import assert_pose_gate, pose_rows

    fields = [torch.from_numpy(golden[f'scene{seed}_{head}'][None])
              .to(device) for head in ('cif', 'caf')]

    def decode():
        return decoder.batch_decode(fields)[0]

    before = cifhr_cuda.LAUNCHES
    anns = decode()
    launches = cifhr_cuda.LAUNCHES - before
    tiers = 1 + len(decoder.last_escalated)
    if launches != tiers or any(a.data.shape != (133, 3) for a in anns):
        raise AssertionError(f'wholebody golden scene {seed}: {launches} '
                             f'CifHr launches for {tiers} tiers')
    assert_pose_gate(pose_rows(anns), list(golden[f'scene{seed}_poses']))
    seconds = []
    for _ in range(3):
        decode()
        seconds.append(decoder.last_decoder_time)
    ops, syncs, busy = decode_profile(decode)
    ms = float(np.median(seconds[1:])) * 1e3
    log(f'wholebody golden (15a) scene {seed}: {len(anns)} poses of 133 '
        f'keypoints match the JAX decode, {launches} CifHr launches '
        f'({tiers} tier{"s" if tiers > 1 else ""}); warm batch-1 decode '
        f'{ms:.2f} ms (median of '
        f'{[round(t * 1e3, 2) for t in seconds[1:]]}), {ops} device ops, '
        f'{syncs} stream syncs, device busy {busy:.3f} ms per decode '
        f'[{card}]')


def wholebody_train_batch(data):
    """One batch of WHOLEBODY_STEP_BATCH of the port's wholebody pipeline
    (augmentation on, 385 px), its head metas and the full-width k16 with
    the wholebody heads (random, seed 0)."""
    from openpifpaf_tpu_torch.models.factory import Factory
    from openpifpaf_tpu_torch.plugins.wholebody import Wholebody

    ann_file, image_dir = data
    datamodule = Wholebody(train_annotations=ann_file,
                           train_image_dir=image_dir, square_edge=TRAIN_EDGE,
                           batch_size=WHOLEBODY_STEP_BATCH)
    model = Factory().from_scratch(
        datamodule.head_metas,
        generator=torch.Generator().manual_seed(TRAIN_SEED))
    np.random.seed(TRAIN_SEED)
    images, targets, _ = next(iter(datamodule.train_loader()))
    field = (TRAIN_EDGE - 1) // 16 + 1
    want = [(WHOLEBODY_STEP_BATCH, 133, 5, field, field),
            (WHOLEBODY_STEP_BATCH, 160, 9, field, field)]
    if [t.shape for t in targets] != want:
        raise AssertionError(f'wholebody targets {[t.shape for t in targets]}'
                             f', want {want}')
    return images, targets, datamodule.head_metas, model


def phase_wholebody_train(data, directory, device, card):
    """15b: one wholebody step on the card against the CPU's float64 step
    (:func:`phase_train_step`), then ``train.main --dataset wholebody
    --basenet shufflenetv2k16`` at the JAX defaults (:func:`train_run`).
    Returns the checkpoint."""
    phase_train_step(wholebody_train_batch(data), device, card,
                     label='wholebody train step (15b)')
    out = os.path.join(directory, 'wholebody', 'model')
    train_run(train_flags(data, out, '--dataset', 'wholebody',
                          prefix='wholebody'),
              out, 'wholebody train run (15b) float32', card)
    return out


@contextlib.contextmanager
def recorded_runs(records):
    """Within: each ``Predictor.fields_batch`` appends to ``records`` its
    image shape, NN ms (CUDA events, the card synchronised) and field
    shapes; each ``CifCaf`` decode (``batch_decode_deferred``, which the
    pipelined loop materialises after the next batch's forward) adds its
    CifHr launches, tiers and ms to the record of its own forward."""
    from openpifpaf_tpu_torch.decoder import CifCaf
    from openpifpaf_tpu_torch.ops import cifhr_cuda
    from openpifpaf_tpu_torch.predictor import Predictor

    fields_batch = Predictor.fields_batch
    batch_decode_deferred = CifCaf.batch_decode_deferred

    def timed_fields(self, image_batch):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fields = fields_batch(self, image_batch)
        end.record()
        torch.cuda.synchronize()
        records.append({
            'images': len(image_batch), 'nn_ms': start.elapsed_time(end),
            'fields': [tuple(f.shape[1:3]) for f in fields],
            'finite': all(bool(torch.isfinite(f).all()) for f in fields),
            'hw': tuple(fields[0].shape[-2:])})
        return fields

    def counted_decode(self, *args, **kwargs):
        record = records[-1]
        materialize = batch_decode_deferred(self, *args, **kwargs)

        def counted():
            before = cifhr_cuda.LAUNCHES
            out = materialize()
            record.update(launches=cifhr_cuda.LAUNCHES - before,
                          tiers=len(out) + len(self.last_escalated),
                          decode_ms=self.last_decoder_time * 1e3,
                          poses=[len(a) for a in out])
            return out

        return counted

    Predictor.fields_batch = timed_fields
    CifCaf.batch_decode_deferred = counted_decode
    try:
        yield records
    finally:
        Predictor.fields_batch = fields_batch
        CifCaf.batch_decode_deferred = batch_decode_deferred


def check_records(records, label, heads, card, at_field_hw=True):
    """Each forward's fields (finite, ``heads``, at FIELD_HW if
    ``at_field_hw``) and one CifHr launch per image per tier; prints each
    one's times."""
    for i, r in enumerate(records):
        if r['fields'] != list(heads) or not r['finite'] \
                or (at_field_hw and r['hw'] != FIELD_HW):
            raise AssertionError(f'{label} forward {i}: fields {r}, want '
                                 f'{heads} at {FIELD_HW}')
        if r.get('launches') != r.get('tiers'):
            raise AssertionError(f'{label} forward {i}: {r.get("launches")} '
                                 f'CifHr launches for {r.get("tiers")} '
                                 'image tiers')
        log(f'{label} forward {i}: batch {r["images"]}, NN '
            f'{r["nn_ms"] / r["images"]:.3f} ms/image (CUDA events), decode '
            f'{r["decode_ms"] / r["images"]:.2f} ms/image, {r["launches"]} '
            f'CifHr launches for {r["tiers"]} image tiers, poses '
            f'{r["poses"]}{" (first call, warm-up)" if i == 0 else ""} '
            f'[{card}]')


def write_requests(directory):
    """The main path's requests (:func:`make_requests`) as JPEGs in
    ``directory``; returns one list of paths per request."""
    import PIL.Image

    files = []
    for i, images in enumerate(make_requests()):
        files.append([])
        for j, image in enumerate(images):
            path = os.path.join(directory, f'request{i}-{j}.jpg')
            PIL.Image.fromarray(image).save(path, quality=95)
            files[-1].append(path)
    return files


def read_predictions(directory):
    """{file name: its JSON predictions} of a ``--json-output`` directory."""
    out = {}
    for name in sorted(os.listdir(directory)):
        with open(os.path.join(directory, name)) as f:
            out[name] = json.load(f)
    return out


def served_predict(port, files, argv, label, heads, card, kernel=None):
    """``predict.main`` over ``files`` (three single-image requests, then a
    batch of two) with ``argv``, in-process, the launch counts set to 0
    just before and read just after: the fields of ``heads``, one CifHr
    launch per image per tier, ``kernel`` (or no backbone kernel)
    launching FORWARD_LAUNCHES times per forward, the kernel on every
    CifHr call's cells bit-equal to its plain version. Returns ({kernel:
    launches}, the records of :func:`recorded_runs`)."""
    from openpifpaf_tpu_torch import decoder, predict
    from torch_port_helpers import restored_statics

    reset_launches(port)
    with recorded_runs([]) as records, \
            kept_cifhr_calls(port.cifhr_cuda) as calls, \
            restored_statics(*decoder.DECODERS):
        predict.main([*files[0], *files[1], *files[2], *argv])
        predict.main([*files[3], '--batch-size', '2', *argv])
    counts = read_launches(port)
    if [r['images'] for r in records] != [1, 1, 1, 2]:
        raise AssertionError(f'{label}: forwards {records}')
    check_records(records, label, heads, card)
    forwards = len(records)
    for name in ('depthwise_conv', 'shuffle_block', 'shuffle_branch2'):
        want = FORWARD_LAUNCHES * forwards if name == kernel else 0
        if counts[name] != want:
            raise AssertionError(f'{label}: {counts[name]} {name} launches '
                                 f'in {forwards} forwards, want {want}')
    if counts['cifhr_accumulate'] != len(calls) or \
            counts['cifhr_accumulate'] != sum(r['launches'] for r in records):
        raise AssertionError(f'{label}: {counts["cifhr_accumulate"]} CifHr '
                             f'launches, {len(calls)} calls')
    check_kept_calls(port, calls, label)
    # the first call at each batch size picks cuDNN's algorithms
    warm = records[1:3]
    log(f'{label}: NN {np.mean([r["nn_ms"] for r in warm]):.3f} ms/image '
        f'(CUDA events), decode '
        f'{np.mean([r["decode_ms"] for r in warm]):.2f} ms/image, the mean '
        f'of the 2 warm batch-1 forwards; launches {counts} [{card}]')
    launches = {'cifhr_accumulate': counts['cifhr_accumulate']}
    if kernel is not None:
        launches[kernel] = counts[kernel]
    return launches, records


def phase_wholebody_predict(port, ckpt, directory, device, card):
    """15c: ``predict.main --checkpoint`` of 15b's checkpoint over 481x641
    JPEGs (padded to 513x641): three single-image requests, then one batch
    of two, in-process (:func:`served_predict`: fields, launches and times
    per forward, the kernel on every F=133 call's cells against its plain
    version); then one warm request of a ``Predictor`` of the checkpoint
    profiled: device ops, stream syncs and the device's busy share of the
    request's wall time. Returns the runs' CifHr launches."""
    from openpifpaf_tpu_torch.predictor import Predictor

    files = write_requests(directory)
    out = os.path.join(directory, 'predictions')
    os.makedirs(out)
    launches = served_predict(
        port, files, ['--checkpoint', ckpt, '--json-output', out],
        'wholebody predict (15c)', WHOLEBODY_HEADS, card)[0][
            'cifhr_accumulate']
    written = sorted(os.listdir(out))
    if len(written) != 5:
        raise AssertionError(f'wholebody predict wrote {written}')
    for name in written:
        with open(os.path.join(out, name)) as f:
            if any(len(a['keypoints']) != 133 * 3 for a in json.load(f)):
                raise AssertionError(f'{name}: not 133 keypoints')

    predictor = Predictor(checkpoint=ckpt, device=device)
    image = make_requests()[0]
    list(predictor.numpy_images(image))
    start = time.perf_counter()
    list(predictor.numpy_images(image))
    wall = (time.perf_counter() - start) * 1e3
    nn_ms, decode_ms = (predictor.last_nn_time * 1e3,
                        predictor.last_decoder_time * 1e3)
    ops, syncs, busy = decode_profile(
        lambda: list(predictor.numpy_images(image)))
    log(f'wholebody predict (15c): {launches} CifHr launches in the runs; '
        f'a warm request: {wall:.2f} ms of wall time (NN {nn_ms:.2f} ms, '
        f'decode {decode_ms:.2f} ms), profiled: {ops} '
        f'device ops, {syncs} stream syncs, device busy {busy:.3f} ms, '
        f'{busy / wall:.3f} of the wall time; predictions {written} '
        f'[{card}]')
    return launches


def phase_wholebody_eval(port, ckpt, directory, card):
    """15d: ``eval_cli.main --dataset wholebody`` (in-process, on the card)
    with 15b's checkpoint over WHOLEBODY_EVAL_IMAGES synthetic images at
    EVAL_LONG_EDGE: the ten WholeBodyMetric stats finite, nn and decoder
    ms per image, the CifHr launches, the kernel on every F=133 call's
    cells against its plain version; the ground truth as predictions gives
    AR 1.0 for each part and AP 1.0 for each part that every person
    shows. Returns the run's CifHr launches."""
    from openpifpaf_tpu_torch import datasets, decoder, eval_cli
    from openpifpaf_tpu_torch.annotation import Annotation
    from openpifpaf_tpu_torch.plugins import wholebody
    from openpifpaf_tpu_torch.plugins.wholebody.metric import PART_SLICES
    from torch_port_helpers import restored_statics, \
        write_synthetic_wholebody

    ann_file, image_dir = write_synthetic_wholebody(
        os.path.join(directory, 'wholebody-eval'),
        n_images=WHOLEBODY_EVAL_IMAGES, image_hw=TRAIN_IMAGE_HW, seed=1)
    out = os.path.join(directory, 'wholebody-eval', 'eval')
    reset_launches(port)
    t0 = time.perf_counter()
    with recorded_runs([]) as records, \
            kept_cifhr_calls(port.cifhr_cuda) as calls, \
            restored_statics(*decoder.DECODERS, eval_cli.Evaluator,
                             *datasets.datamodules().values()):
        eval_cli.main(['--dataset', 'wholebody', '--checkpoint', ckpt,
                       '--wholebody-val-annotations', ann_file,
                       '--wholebody-val-image-dir', image_dir,
                       '--wholebody-eval-long-edge', str(EVAL_LONG_EDGE),
                       '--eval-loader-warmup', '0', '--output', out])
    wall = time.perf_counter() - t0
    launches = read_launches(port)['cifhr_accumulate']
    with open(out + '.stats.json') as f:
        stats = json.load(f)
    n_images = stats['n_images']
    if not (len(stats['stats']) == 10 and np.all(np.isfinite(stats['stats']))
            and stats['text_labels'][::2] == [
                f'AP_{p}' for p in ('body', 'foot', 'face', 'hand',
                                    'wholebody')]
            and n_images == len(records) > 0):
        raise AssertionError(f'wholebody eval stats {stats}, {len(records)} '
                             'forwards')
    if launches != len(calls) or launches != sum(r['launches']
                                                 for r in records):
        raise AssertionError(f'wholebody eval: {launches} CifHr launches, '
                             f'{len(calls)} calls')
    check_records(records, 'wholebody eval (15d)', WHOLEBODY_HEADS, card,
                  at_field_hw=False)
    check_kept_calls(port, calls, 'wholebody eval (15d)')
    per_image = {k: stats[k] / n_images * 1e3
                 for k in ('total_time', 'nn_time', 'decoder_time')}
    log(f'wholebody eval (15d): {n_images} images at long edge '
        f'{EVAL_LONG_EDGE} (fields {sorted({r["hw"] for r in records})}), '
        f'{launches} CifHr launches;'
        f' per image total {per_image["total_time"]:.2f} ms, nn '
        f'{per_image["nn_time"]:.2f} ms, decoder '
        f'{per_image["decoder_time"]:.2f} ms (the first image included); '
        f'stats {dict(zip(stats["text_labels"], stats["stats"]))} (random '
        f'weights after {TRAIN_STEPS} steps); whole command {wall:.1f} s '
        f'[{card}]')

    with open(ann_file) as f:
        data = json.load(f)
    with restored_statics(wholebody.Wholebody):
        wholebody.Wholebody.eval_annotations = ann_file
        metric, = wholebody.Wholebody().metrics()
    for image in data['images']:
        metric.accumulate([
            Annotation(wholebody.WHOLEBODY_KEYPOINTS,
                       wholebody.WHOLEBODY_SKELETON).set(
                np.asarray(a['keypoints'], np.float32).reshape(133, 3),
                fixed_score=1.0, fixed_bbox=a['bbox'])
            for a in data['annotations'] if a['image_id'] == image['id']],
            {'image_id': image['id']})
    # a person whose part lies outside the image is an ignored ground
    # truth of that part, while its prediction still counts (COCO's
    # protocol, JAX's metric): AP is 1.0 exactly for the parts every
    # person shows, AR 1.0 for all
    gt_stats = metric.stats()['stats']
    hidden = {part: sum(not np.any(np.asarray(a['keypoints']).reshape(
        133, 3)[sl, 2] > 0) for a in data['annotations'])
        for part, sl in PART_SLICES.items()}
    for i, part in enumerate(PART_SLICES):
        ap, ar = gt_stats[2 * i:2 * i + 2]
        if ar != 1.0 or (ap == 1.0) != (hidden[part] == 0):
            raise AssertionError(f'wholebody ground truth as predictions: '
                                 f'{part} AP {ap}, AR {ar} with '
                                 f'{hidden[part]} people hiding the part')
    log(f'wholebody eval (15d): the ground truth as predictions gives AR 1.0 '
        f'for every part and AP {dict(zip(PART_SLICES, gt_stats[::2]))}, '
        f'1.0 for every part that no person hides (people hiding each '
        f'part: {hidden})')
    return launches


def plugin_metas(name, flags):
    """The head metas of data module ``name`` configured by ``flags``
    (its class settings are put back after)."""
    import argparse
    from openpifpaf_tpu_torch import datasets
    from torch_port_helpers import restored_statics

    cls = datasets.datamodules()[name]
    parser = argparse.ArgumentParser()
    with restored_statics(cls):
        cls.cli(parser)
        cls.configure(parser.parse_args(list(flags)))
        return cls().head_metas


def serve_plugin(port, label, name, flags, n_kp, n_edges, device, card):
    """One request of a random full-width k16 with the heads of data
    module ``name`` under ``flags``: its field shapes and CifHr launches.
    Returns (launches, the model)."""
    from openpifpaf_tpu_torch.predictor import Predictor

    metas = plugin_metas(name, flags)
    if [m.n_fields for m in metas] != [n_kp, n_edges]:
        raise AssertionError(f'{label}: heads {metas}')
    predictor = Predictor(head_metas=metas, device=device)
    reset_launches(port)
    serve(predictor, make_requests()[:1], card, f'plugin (15e) {label}',
          heads=((n_kp, 5), (n_edges, 8)))
    count = read_launches(port)['cifhr_accumulate']
    if count == 0:
        raise AssertionError(f'{label}: no CifHr launch')
    log(f'plugin (15e) {label}: {n_kp} CIF fields, {n_edges} CAF edges at '
        f'{FIELD_HW}, {count} CifHr launches')
    return count, predictor.model


def phase_plugins(port, directory, device, card):
    """15e: each of PLUGIN_CASES served by a random full-width k16 with its
    heads (seed 0): one request, its field shapes, its CifHr launches, the
    kernel on each call's cells against its plain version; then
    the tracking benchmark wrapper's ``--crowdpose`` with the crowdpose
    model saved as a checkpoint, over a synthetic CrowdPose set whose
    ``crowdIndex`` values cover the three buckets: each bucket's eval sees
    the ids of CROWDPOSE_BUCKETS. Returns the requests' CifHr launches."""
    from openpifpaf_tpu_torch.plugins.posetrack import benchmark
    from torch_port_helpers import write_synthetic_crowdpose

    launches = 0
    crowdpose_model = None
    with kept_cifhr_calls(port.cifhr_cuda) as calls:
        for label, name, flags, n_kp, n_edges in PLUGIN_CASES:
            count, model = serve_plugin(port, label, name, flags, n_kp,
                                        n_edges, device, card)
            launches += count
            if name == 'crowdpose':
                crowdpose_model = model
    check_kept_calls(port, calls, 'plugin (15e)')

    ann_file, image_dir = write_synthetic_crowdpose(
        os.path.join(directory, 'crowdpose'), n_images=CROWDPOSE_IMAGES,
        image_hw=TRAIN_IMAGE_HW, seed=0)
    with open(ann_file) as f:
        data = json.load(f)
    with_people = {a['image_id'] for a in data['annotations']}
    want = {}
    for bucket, (lo, hi) in CROWDPOSE_BUCKETS.items():
        want[bucket] = sorted(
            i['id'] for i in data['images'] if i['id'] in with_people
            and (lo <= i['crowdIndex'] < hi
                 or (bucket == 'hard' and i['crowdIndex'] == hi)))
        if not want[bucket]:
            raise AssertionError(f'crowdpose bucket {bucket} is empty')
    want[''] = sorted(with_people)
    ckpt = os.path.join(directory, 'crowdpose-k16')
    save_checkpoint(ckpt, crowdpose_model, 'shufflenetv2k16')
    out = os.path.join(directory, 'crowdpose-bench')
    # the wrapper's evals are ``python -m`` processes of this checkout
    pythonpath = os.environ.get('PYTHONPATH')
    os.environ['PYTHONPATH'] = os.pathsep.join(filter(None, (ROOT,
                                                             pythonpath)))
    t0 = time.perf_counter()
    try:
        benchmark.main(['--checkpoints', ckpt, '--crowdpose', '--output',
                        out, '--crowdpose-val-annotations', ann_file,
                        '--crowdpose-image-dir', image_dir,
                        '--eval-loader-warmup', '0', '--loader-workers',
                        '0'])
    finally:
        if pythonpath is None:
            del os.environ['PYTHONPATH']
        else:
            os.environ['PYTHONPATH'] = pythonpath
    wall = time.perf_counter() - t0
    for suffix in ('', '.easy', '.medium', '.hard'):
        with open(os.path.join(out + suffix, ckpt.replace('/', '-')
                               + '.eval-crowdpose.stats.json')) as f:
            stats = json.load(f)
        bucket = suffix.lstrip('.')
        if not (stats['n_images'] == len(want[bucket])
                and len(stats['stats']) == 10
                and np.all(np.isfinite(stats['stats']))):
            raise AssertionError(f'crowdpose benchmark {suffix or "all"}: '
                                 f'{stats}, want the ids {want[bucket]}')
        log(f'plugin (15e) crowdpose benchmark {bucket or "all"}: '
            f'{stats["n_images"]} images (ids {want[bucket]}), decoder '
            f'{stats["decoder_time"] / stats["n_images"] * 1e3:.2f} ms/image')
    log(f'plugin (15e) crowdpose benchmark: 4 evals in {wall:.1f} s '
        f'[{card}]')
    return launches


def phase_plugins_path(port, device, card):
    """Phase 15: (a)-(e); returns the CifHr launches of (c)-(e)."""
    import tempfile
    from torch_port_helpers import write_synthetic_wholebody

    phase_wholebody_golden(port, device, card)
    with tempfile.TemporaryDirectory() as directory:
        data = write_synthetic_wholebody(
            os.path.join(directory, 'wholebody-data'), n_images=TRAIN_IMAGES,
            image_hw=TRAIN_IMAGE_HW, seed=TRAIN_SEED)
        ckpt = phase_wholebody_train(data, directory, device, card)
        launches = phase_wholebody_predict(port, ckpt, directory, device,
                                           card)
        launches += phase_wholebody_eval(port, ckpt, directory, card)
        launches += phase_plugins(port, directory, device, card)
    log(f'phase 15: {launches} CifHr launches in (c)-(e)')
    return launches


#: phase 16: the cocodet head of 80 categories at stride 16, the nuscenes
#: head of 23
DET_HEADS = ((80, 6),)
#: 16b: the engines served under the cocodet head and their kernels
DET_ENGINES = {'pallas': 'shuffle_block', 'dwpallas': 'depthwise_conv'}
#: 16c: the run at the cocodet default square edge (the one step against
#: the CPU's float64 step at TRAIN_EDGE, as 15b)
DET_TRAIN_EDGE = 513
DET_STEP_BATCH = 2
#: 16d: the eval's synthetic detection images (TRAIN_IMAGE_HW, seed 1) at
#: the cocodet default long edge 641
DET_EVAL_IMAGES = 4
#: 16e: the published detection configurations served at random weights:
#: (label, backbone, data module, categories)
DET_CASES = (('resnet18 cocodet', 'resnet18', 'cocodet', 80),
             ('mobilenetv3small cocodet', 'mobilenetv3small', 'cocodet', 80),
             ('shufflenetv2k16 nuscenes', 'shufflenetv2k16', 'nuscenes', 23))
#: 16e: the cifar10 run: synthetic CIFAR batches (seed 0), train steps of
#: a batch of 8, then the test batch evaluated
CIFAR_TRAIN_IMAGES = 64
CIFAR_TEST_IMAGES = 16
CIFAR_STEPS = 4


def det_annotations(golden, key):
    """(category, score, xywh box) of the kept detections of the golden
    arrays ``key``, in the order of ``decoder.CifDet``'s host loop."""
    score = golden[f'{key}_score']
    rows = []
    for j in np.argsort(-score):
        if golden[f'{key}_keep'][j]:
            box = golden[f'{key}_box'][j].copy()
            box[2:] -= box[:2]
            rows.append((int(golden[f'{key}_category'][j]), float(score[j]),
                         box))
    return rows


def assert_det_rows(anns, rows, label):
    """The detection gate on ``decoder.CifDet``'s annotations: the same
    count, the same categories in the same order, scores within 2e-6,
    boxes within 1e-3 px."""
    if len(anns) != len(rows) or [a.category_id for a in anns] != [
            r[0] for r in rows]:
        raise AssertionError(f'{label}: categories '
                             f'{[a.category_id for a in anns]}, want '
                             f'{[r[0] for r in rows]}')
    for a, (_, score, box) in zip(anns, rows):
        if abs(a.score - score) > 2e-6 or np.abs(a.bbox - box).max() > 1e-3:
            raise AssertionError(f'{label}: {a.score} {a.bbox}, want '
                                 f'{score} {box}')


def phase_det_golden(device, card):
    """16a: ``decoder.CifDet.batch_decode`` on the card on the scenes of
    ``tests/golden/torch_cifdet_golden.npz`` under each configuration:
    the raw decode on every seed slot and the annotations within the
    detection gate; warm decode ms (median of 3 after one), device ops,
    stream syncs and busy ms per decode."""
    import dataclasses
    from openpifpaf_tpu_torch import headmeta
    from openpifpaf_tpu_torch.decoder import CifDet
    from openpifpaf_tpu_torch.ops.decode_cifdet import build_cifdet_decoder
    from torch_port_helpers import CIFDET_CONFIGS, CIFDET_GOLDEN, \
        CIFDET_SCENES, CIFDET_STRIDE, assert_det_gate, cifdet_golden_fields

    golden = np.load(CIFDET_GOLDEN)
    fields = cifdet_golden_fields(golden)
    meta = headmeta.CifDet('cifdet', 'cocodet', categories=[
        f'c{i}' for i in range(fields['sparse'].shape[0])])
    meta.head_index, meta.base_stride = 0, CIFDET_STRIDE
    for scene in CIFDET_SCENES:
        batch = [torch.from_numpy(fields[scene][None]).to(device)]
        for config, overrides in CIFDET_CONFIGS.items():
            key = f'{scene}_{config}'
            decoder = CifDet([meta])
            decoder.config = dataclasses.replace(decoder.config, **overrides)
            raw = build_cifdet_decoder(stride=CIFDET_STRIDE,
                                       config=decoder.config)(batch[0])
            if raw['score'].device != batch[0].device:
                raise AssertionError(f'det golden {key}: the decode left '
                                     'the fields\' device')
            assert_det_gate({k: v[0].cpu().numpy() for k, v in raw.items()},
                            {k: golden[f'{key}_{k}'] for k in (
                                'category', 'score', 'box', 'keep')}, key)
            anns = decoder.batch_decode(batch)[0]
            assert_det_rows(anns, det_annotations(golden, key),
                            f'det golden (16a) {key}')
            seconds = []
            for _ in range(3):
                decoder.batch_decode(batch)
                seconds.append(decoder.last_decoder_time)
            ops, syncs, busy = decode_profile(
                lambda: decoder.batch_decode(batch))
            log(f'det golden (16a) {key}: {len(anns)} detections of '
                f'{len({a.category_id for a in anns})} categories match the '
                f'JAX decode; warm batch-1 decode '
                f'{np.median(seconds[1:]) * 1e3:.2f} ms (median of '
                f'{[round(t * 1e3, 2) for t in seconds[1:]]}), {ops} device '
                f'ops, {syncs} stream syncs, device busy {busy:.3f} ms per '
                f'decode [{card}]')


def det_train_batch(data):
    """One batch of DET_STEP_BATCH of the port's cocodet pipeline
    (augmentation on, TRAIN_EDGE), its head metas and the full-width k16
    with the cocodet head (random, seed 0)."""
    from openpifpaf_tpu_torch.models.factory import Factory
    from openpifpaf_tpu_torch.plugins.coco.cocodet import CocoDet
    from torch_port_helpers import restored_statics

    with restored_statics(CocoDet):
        CocoDet.train_annotations, CocoDet.train_image_dir = data
        CocoDet.square_edge = TRAIN_EDGE
        datamodule = CocoDet()
        datamodule.batch_size = DET_STEP_BATCH
        model = Factory().from_scratch(
            datamodule.head_metas,
            generator=torch.Generator().manual_seed(TRAIN_SEED))
        np.random.seed(TRAIN_SEED)
        images, targets, _ = next(iter(datamodule.train_loader()))
    field = (TRAIN_EDGE - 1) // 16 + 1
    want = [(DET_STEP_BATCH, 80, 7, field, field)]
    if [t.shape for t in targets] != want \
            or not (targets[0][:, :, 0] == 1.0).any():
        raise AssertionError(f'cocodet targets {[t.shape for t in targets]}'
                             f', want {want} with positives')
    return images, targets, datamodule.head_metas, model


def phase_det_train(data, directory, device, card):
    """16c: one cocodet step on the card against the CPU's float64 step
    (:func:`phase_train_step`), ``train.main --dataset cocodet`` at the
    JAX defaults (:func:`train_run`, square edge DET_TRAIN_EDGE), and
    ``predict.main --checkpoint`` of its checkpoint writing
    ``AnnotationDet.json_data()``. Returns the checkpoint."""
    import PIL.Image
    from openpifpaf_tpu_torch import datasets, decoder, predict
    from torch_port_helpers import restored_statics

    phase_train_step(det_train_batch(data), device, card,
                     label='cocodet train step (16c)')
    out = os.path.join(directory, 'cocodet', 'model')
    with restored_statics(*decoder.DECODERS,
                          *datasets.datamodules().values()):
        train_run(train_flags(data, out, '--dataset', 'cocodet',
                              '--cocodet-square-edge', str(DET_TRAIN_EDGE),
                              prefix='cocodet'),
                  out, f'cocodet train run (16c) float32, '
                  f'{DET_TRAIN_EDGE} px', card)
        path = os.path.join(directory, 'det-request.jpg')
        PIL.Image.fromarray(make_requests()[0][0]).save(path, quality=95)
        # thresholds 0: every seed is a detection, whatever the steps made
        # of the weights
        predict.main([path, '--checkpoint', out, '--json-output', directory,
                      '--cif-th', '0', '--seed-threshold', '0',
                      '--instance-threshold', '0'])
    with open(path + '.predictions.json') as f:
        dets = json.load(f)
    if not dets or any(sorted(d) != ['bbox', 'category', 'category_id',
                                     'score'] for d in dets):
        raise AssertionError(f'cocodet predict JSON: {dets[:3]}')
    log(f'cocodet predict (16c): {len(dets)} detections in the JSON, first '
        f'{dets[0]} [{card}]')
    return out


def phase_det_eval(ckpt, directory, card):
    """16d: ``eval_cli.main --dataset cocodet`` with 16c's checkpoint over
    DET_EVAL_IMAGES synthetic images at the default long edge 641: the
    ten bbox stats of ``metric.Coco`` finite, nn and decoder ms per
    image; the ground truth as predictions gives AP and AR 1.0."""
    from openpifpaf_tpu_torch import datasets, decoder, eval_cli
    from openpifpaf_tpu_torch.annotation import AnnotationDet
    from openpifpaf_tpu_torch.plugins.coco.cocodet import CocoDet
    from openpifpaf_tpu_torch.plugins.coco.constants import COCO_CATEGORIES
    from torch_port_helpers import restored_statics, write_synthetic_cocodet

    ann_file, image_dir = write_synthetic_cocodet(
        os.path.join(directory, 'cocodet-eval'), n_images=DET_EVAL_IMAGES,
        image_hw=TRAIN_IMAGE_HW, seed=1)
    out = os.path.join(directory, 'cocodet-eval', 'eval')
    t0 = time.perf_counter()
    with restored_statics(*decoder.DECODERS, eval_cli.Evaluator,
                          *datasets.datamodules().values()):
        eval_cli.main(['--dataset', 'cocodet', '--checkpoint', ckpt,
                       '--cocodet-val-annotations', ann_file,
                       '--cocodet-val-image-dir', image_dir,
                       '--eval-loader-warmup', '0', '--output', out])
    wall = time.perf_counter() - t0
    with open(out + '.stats.json') as f:
        stats = json.load(f)
    with open(ann_file) as f:
        data = json.load(f)
    # the eval keeps the images with a box that is not a crowd region
    n_images = stats['n_images']
    want = len({a['image_id'] for a in data['annotations']
                if not a['iscrowd']})
    if not (len(stats['stats']) == 10 and np.all(np.isfinite(stats['stats']))
            and n_images == want > 0):
        raise AssertionError(f'cocodet eval stats {stats}, want {want} '
                             'images')
    per_image = {k: stats[k] / n_images * 1e3
                 for k in ('total_time', 'nn_time', 'decoder_time')}
    log(f'cocodet eval (16d): {n_images} of {DET_EVAL_IMAGES} images (the '
        f'others hold crowd regions only) at long edge 641, per image '
        f'total {per_image["total_time"]:.2f} ms, nn '
        f'{per_image["nn_time"]:.2f} ms, decoder '
        f'{per_image["decoder_time"]:.2f} ms (the first image included); '
        f'stats {dict(zip(stats["text_labels"], stats["stats"]))} (8-step '
        f'weights); whole command {wall:.1f} s [{card}]')

    with restored_statics(CocoDet):
        CocoDet.eval_annotations = ann_file
        coco, = CocoDet().metrics()
    for image in data['images']:
        coco.accumulate([
            AnnotationDet(COCO_CATEGORIES).set(a['category_id'], 1.0,
                                               a['bbox'])
            for a in data['annotations']
            if a['image_id'] == image['id'] and not a['iscrowd']],
            {'image_id': image['id']})
    gt = dict(zip(*[coco.stats()[k] for k in ('text_labels', 'stats')]))
    if gt['AP'] != 1.0 or gt['AR'] != 1.0:
        raise AssertionError(f'cocodet ground truth as predictions: {gt}')
    log(f'cocodet eval (16d): the ground truth as predictions gives {gt}')


def phase_det_others(directory, device, card):
    """16e: each of DET_CASES served by a random model (seed 0), one
    request with its field shapes; then ``train.main --dataset cifar10
    --basenet cifar10net`` for CIFAR_STEPS steps on synthetic CIFAR
    batches and ``eval_cli.main --dataset cifar10`` of its checkpoint:
    the ``Classification`` accuracy finite."""
    from openpifpaf_tpu_torch import datasets, decoder, eval_cli, train
    from openpifpaf_tpu_torch.models.factory import Factory
    from openpifpaf_tpu_torch.predictor import Predictor
    from torch_port_helpers import restored_statics, write_synthetic_cifar10

    for label, base_name, name, n_categories in DET_CASES:
        metas = plugin_metas(name, ())
        model = Factory(base_name).from_scratch(
            metas, generator=torch.Generator().manual_seed(TRAIN_SEED))
        serve(Predictor(model=model, device=device), make_requests()[:1],
              card, f'det (16e) {label}', heads=((n_categories, 6),))

    root = write_synthetic_cifar10(os.path.join(directory, 'cifar10'),
                                   n_train=CIFAR_TRAIN_IMAGES,
                                   n_test=CIFAR_TEST_IMAGES, seed=TRAIN_SEED)
    out = os.path.join(directory, 'cifar10', 'model')
    t0 = time.perf_counter()
    with restored_statics(*decoder.DECODERS, eval_cli.Evaluator,
                          *datasets.datamodules().values()):
        train.main(['--dataset', 'cifar10', '--basenet', 'cifar10net',
                    '--cifar10-root-dir', root, '--batch-size', '8',
                    '--epochs', '1', '--train-batches', str(CIFAR_STEPS),
                    '--val-batches', '1', '--log-interval', '1',
                    '--output', out])
        eval_cli.main(['--dataset', 'cifar10', '--checkpoint', out,
                       '--cifar10-root-dir', root, '--eval-loader-warmup',
                       '0', '--output', out + '.eval'])
    wall = time.perf_counter() - t0
    train_lines, val_lines = read_train_log(out + '.log')
    with open(out + '.eval.stats.json') as f:
        stats = json.load(f)
    if len(train_lines) != CIFAR_STEPS or not np.all(np.isfinite(
            [line['loss'] for line in train_lines + val_lines])) \
            or stats['text_labels'] != ['accuracy'] \
            or not np.isfinite(stats['stats'][0]) \
            or stats['n_images'] != CIFAR_TEST_IMAGES:
        raise AssertionError(f'cifar10: {train_lines} {val_lines} {stats}')
    log(f'det (16e) cifar10: {CIFAR_STEPS} steps (losses '
        f'{[line["loss"] for line in train_lines]}), eval of '
        f'{stats["n_images"]} images: accuracy {stats["stats"][0]}, decoder '
        f'{stats["decoder_time"] / stats["n_images"] * 1e3:.2f} ms/image; '
        f'train and eval {wall:.1f} s [{card}]')


def phase_detection(port, device, card):
    """Phase 16: (a)-(e); returns {kernel: launches} of (b)."""
    import tempfile
    from openpifpaf_tpu_torch.predictor import Predictor
    from torch_port_helpers import write_synthetic_cocodet

    t0 = time.perf_counter()
    phase_det_golden(device, card)
    predictor = Predictor(head_metas=plugin_metas('cocodet', ()),
                          device=device)
    reset_launches(port)
    serve(predictor, make_requests(), card, 'cocodet (16b) module graph',
          heads=DET_HEADS)
    if any(read_launches(port).values()):
        raise AssertionError(f'cocodet module graph: launches '
                             f'{read_launches(port)}')
    launches, _ = serve_engines(port, predictor, DET_ENGINES, device, card,
                                'cocodet (16b)', heads=DET_HEADS)
    with tempfile.TemporaryDirectory() as directory:
        data = write_synthetic_cocodet(
            os.path.join(directory, 'cocodet-data'), n_images=TRAIN_IMAGES,
            image_hw=TRAIN_IMAGE_HW, seed=TRAIN_SEED)
        ckpt = phase_det_train(data, directory, device, card)
        phase_det_eval(ckpt, directory, card)
        phase_det_others(directory, device, card)
    log(f'phase 16: launches {launches} in (b); {time.perf_counter() - t0:.1f}'
        f' s [{card}]')
    return launches


#: phase 17: the mix cocokp-cocodet and its --dataset-weights
MIX_WEIGHTS = (2.0, 1.0)
#: 17b: the heads of the mix's checkpoint
MIX_HEADS = ((17, 5), (19, 8), (80, 6))
#: 17b: the ways each request is served, as Predictor settings
TTA_WAYS = {'plain': {}, 'hflip_tta': {'hflip_tta': True},
            'multi_scale': {'multi_scale': True},
            'both': {'hflip_tta': True, 'multi_scale': True}}
#: 17b: the engines served four ways (their kernel, or None), and the one
#: served with hflip TTA only
TTA_ENGINES = {'flax': None, 'pallas': 'shuffle_block'}
TTA_ONLY_ENGINES = {'dwpallas': 'depthwise_conv'}
#: 17b: requests of one image each (IMAGE_HW JPEGs)
TTA_REQUESTS = 1
#: 17b: the batch forwarded whole and in chunks of CHUNK_SIZE (JAX's
#: nn_chunk_size; the port's default is 0, whole)
CHUNK_BATCH = 16
CHUNK_SIZE = 8
#: 17b-c: decoder thresholds 0, so that the train steps' weights give poses
#: and boxes at every scale and the answer comparisons meet them (as
#: 16c); pose budgets of 16, which both tiers fill, so that the merges'
#: pairwise OKS stays cheap
MIX_DECODER_FLAGS = ('--cif-th', '0', '--seed-threshold', '0',
                     '--instance-threshold', '0', '--decoder-poses', '16',
                     '--decoder-crowd-poses', '16')
#: 17b: the scene drawn into the fields for the multi-scale merges at the
#: default thresholds: two people (x, height) and two boxes (category
#: index, x, y, width, height), as shares of the image's valid area, the
#: people at mid height
DRAWN_PEOPLE = ((0.3, 0.8), (0.75, 0.6))
DRAWN_BOXES = ((0, 0.3, 0.5, 0.3, 0.8), (2, 0.75, 0.5, 0.25, 0.6))
#: 17c: the eval's synthetic COCO images
MIX_EVAL_IMAGES = 2


def mix_train_flags(kp_data, det_data, out):
    """``train.main``'s flags for the cocokp-cocodet run at the JAX
    defaults (TRAIN_BATCH, TRAIN_EDGE for both datasets, SGD, float32)."""
    det_ann, det_dir = det_data
    return train_flags(
        kp_data, out, '--dataset', 'cocokp-cocodet', '--dataset-weights',
        *(str(w) for w in MIX_WEIGHTS),
        '--cocodet-train-annotations', det_ann,
        '--cocodet-val-annotations', det_ann,
        '--cocodet-train-image-dir', det_dir,
        '--cocodet-val-image-dir', det_dir,
        '--cocodet-square-edge', str(TRAIN_EDGE))


def phase_mix_train(kp_data, det_data, directory, card):
    """17a: ``train.main --dataset cocokp-cocodet --dataset-weights 2 1``
    with k16 at full width (:func:`train_run`): the dataset of each logged
    step, read from the None pattern of its head losses, in the
    ``MultiLoader`` order computed on the host; three heads in the
    checkpoint. Returns the checkpoint."""
    from openpifpaf_tpu_torch import datasets, decoder
    from torch_port_helpers import restored_statics

    out = os.path.join(directory, 'mix', 'model')
    with restored_statics(*decoder.DECODERS, datasets.MultiDataModule,
                          *datasets.datamodules().values()):
        train_run(mix_train_flags(kp_data, det_data, out), out,
                  'cocokp-cocodet train run (17a) float32, '
                  f'{TRAIN_EDGE} px, weights {MIX_WEIGHTS}', card)
        datamodule = datasets.factory('cocokp-cocodet')
        datamodule.batch_size = TRAIN_BATCH
        order = datamodule.train_loader().order()[:TRAIN_STEPS]
    train_lines, val_lines = read_train_log(out + '.log')
    patterns = [[h is None for h in line['head_losses']]
                for line in train_lines]
    want = {0: [False] * 6 + [True] * 2, 1: [True] * 6 + [False] * 2}
    if patterns != [want[i] for i in order]:
        raise AssertionError(f'17a: head-loss None patterns {patterns}, '
                             f'want those of the host order {order}')
    with open(out + '.json') as f:
        metas = json.load(f)['head_metas']
    heads = [(m['dataset'], m['name'], m['head_index']) for m in metas]
    if heads != [('cocokp', 'cif', 0), ('cocokp', 'caf', 1),
                 ('cocodet', 'cifdet', 2)]:
        raise AssertionError(f'17a: checkpoint heads {heads}')
    log(f'cocokp-cocodet (17a): batches from datasets {order} '
        f'(0 cocokp, 1 cocodet; the host MultiLoader order), head-loss None '
        f'pattern per step {["".join("N" if n else "x" for n in p) for p in patterns]}, '
        f'validation head losses {val_lines[0]["head_losses"]}; checkpoint '
        f'heads {heads} [{card}]')
    return out


def tta_fields_check(predictors, cpu_predictor, label):
    """hflip TTA fields on the card: the module graph's against the same
    checkpoint's on the CPU (atol/rtol 1e-4), each engine's against the
    module graph's (ENGINE_TOL), TF32 off, on a small image whose width
    the bucket pad widens."""
    rng = np.random.RandomState(1)
    image = rng.randn(1, 129, 145, 3).astype(np.float32)
    cpu_predictor.hflip_tta = True
    cpu = cpu_predictor.fields_batch(image)
    with no_tf32():
        out = {}
        for engine, p in predictors.items():
            p.hflip_tta = True
            out[engine] = p.fields_batch(image)
            p.hflip_tta = False
    errs = compare_fields([o.cpu() for o in out['flax']], cpu,
                          f'{label} TTA vs CPU', rtol=1e-4, atol=1e-4)
    log(f'{label}: hflip TTA fields of the module graph vs the CPU, max abs '
        f'err per head {errs} (TF32 off, rtol/atol 1e-4)')
    for engine in predictors:
        if engine == 'flax':
            continue
        errs = compare_fields(out[engine], out['flax'],
                              f'{label} TTA {engine}', **ENGINE_TOL)
        log(f'{label}: hflip TTA fields of {engine} vs the module graph, '
            f'max abs err per head {errs} (TF32 off, rtol/atol '
            f'{ENGINE_TOL["rtol"]})')


def serve_ways(port, predictor, engine, kernel, files, ways, card, label):
    """``predictor.images`` of each request file under each of ``ways``,
    after one warm-up request: fields of MIX_HEADS for every forward, the
    engine's kernel launching FORWARD_LAUNCHES times per forward and no
    other backbone kernel; poses and boxes in every answer, under
    multi-scale the merges' output; NN and decode ms per image. Returns
    {kernel: launches} of the timed requests, the answers per way and the
    (H, W) of every forward."""
    forwards = []
    shapes = set()
    fields_batch = predictor.fields_batch
    forward = predictor._forward

    def counted_forward(images):
        forwards.append(tuple(images.shape[1:3]))
        shapes.add(forwards[-1])
        return forward(images)

    def recording_fields_batch(image_batch):
        fields = fields_batch(image_batch)
        for f, (n_fields, n_components) in zip(fields, MIX_HEADS):
            if tuple(f.shape[1:3]) != (n_fields, n_components) \
                    or not bool(torch.isfinite(f).all()):
                raise AssertionError(f'{label}: field {tuple(f.shape)}')
        return fields

    predictor._forward = counted_forward
    predictor.fields_batch = recording_fields_batch
    merges = counted_merges(predictor)
    launches = {}
    answers = {}
    try:
        for way in ways:
            for k, v in TTA_WAYS[way].items():
                setattr(predictor, k, v)
            # warm-up: cuDNN's algorithm picks at each scale's shape
            list(predictor.images(files[:1]))
            reset_launches(port)
            del forwards[:]
            for kind in merges:
                del merges[kind][:]
            nn0, dec0 = predictor.total_nn_time, predictor.total_decoder_time
            start = time.perf_counter()
            answers[way] = [[ann.json_data() for ann in pred]
                            for pred, _, _ in predictor.images(files)]
            wall = time.perf_counter() - start
            counts = read_launches(port)
            for name in ('depthwise_conv', 'shuffle_block',
                         'shuffle_branch2'):
                want = FORWARD_LAUNCHES * len(forwards) \
                    if name == kernel else 0
                if counts[name] != want:
                    raise AssertionError(
                        f'{label} {engine} {way}: {counts[name]} {name} '
                        f'launches in {len(forwards)} forwards, want {want}')
            if counts['cifhr_accumulate'] == 0:
                raise AssertionError(f'{label} {engine} {way}: no CifHr '
                                     'launch')
            for name in ('cifhr_accumulate', 'depthwise_conv',
                         'shuffle_block'):
                launches[name] = launches.get(name, 0) + counts[name]
            poses = [sum('keypoints' in a for a in anns)
                     for anns in answers[way]]
            boxes = [len(anns) - n for anns, n in zip(answers[way], poses)]
            if not (all(poses) and all(boxes)):
                raise AssertionError(f'{label} {engine} {way}: poses {poses}, '
                                     f'boxes {boxes} per request')
            merged = ''
            if TTA_WAYS[way].get('multi_scale'):
                kept = sum(k for kind in merges for _, k in merges[kind])
                if not (len(merges['poses']) == len(files)
                        and kept == sum(len(a) for a in answers[way])):
                    raise AssertionError(
                        f'{label} {engine} {way}: merges (given, kept) '
                        f'{merges}, answers {[len(a) for a in answers[way]]}')
                merged = (f', merged (given, kept) per request poses '
                          f'{merges["poses"]} boxes {merges["boxes"]}')
            n = len(files)
            log(f'{label} {engine} {way}: per image NN '
                f'{(predictor.total_nn_time - nn0) / n * 1e3:.2f} ms, decode '
                f'{(predictor.total_decoder_time - dec0) / n * 1e3:.2f} ms, '
                f'wall {wall / n * 1e3:.2f} ms over {n} requests; '
                f'{len(forwards)} forwards at {sorted(set(forwards))}, '
                f'launches {counts}, poses {poses} boxes {boxes} per '
                f'request{merged} [{card}]')
            for k in TTA_WAYS[way]:
                setattr(predictor, k, False)
    finally:
        del predictor._forward
        del predictor.fields_batch
        del predictor._merge_annotations
        del predictor._merge_detections
    return launches, answers, shapes


def counted_merges(predictor):
    """Wraps ``predictor``'s two merges to record (given, kept) of each
    call in the {'poses': [...], 'boxes': [...]} this returns; deleting
    the instance attributes puts the merges back."""
    merges = {'poses': [], 'boxes': []}
    for kind, name in (('poses', '_merge_annotations'),
                       ('boxes', '_merge_detections')):
        def counted(anns, kind=kind, merge=getattr(predictor, name)):
            kept = merge(anns)
            merges[kind].append((len(anns), len(kept)))
            return kept
        setattr(predictor, name, counted)
    return merges


def drawn_fields(device, metas):
    """A ``fields_batch`` that draws DRAWN_PEOPLE and DRAWN_BOXES at
    stride 16 into the valid area of each (1, H, W, 3) batch (its padding
    is 0 after normalisation), on ``device``."""
    from torch_port_helpers import cifdet_scene, port_person, \
        port_pose_fields

    def fields_batch(image_batch):
        image = np.asarray(image_batch)[0]
        rows, = np.nonzero(np.abs(image).sum(axis=(1, 2)))
        cols, = np.nonzero(np.abs(image).sum(axis=(0, 2)))
        y0, h = rows[0], rows[-1] + 1 - rows[0]
        x0, w = cols[0], cols[-1] + 1 - cols[0]
        people = [port_person(x0 + fx * w, y0 + 0.5 * h, fh * h,
                              np.random.RandomState(i))
                  for i, (fx, fh) in enumerate(DRAWN_PEOPLE)]
        cif, caf = port_pose_fields(people, image.shape[:2], *metas[:2])
        det = cifdet_scene(
            [(c, x0 + fx * w, y0 + fy * h, fw * w, fh * h)
             for c, fx, fy, fw, fh in DRAWN_BOXES],
            seed=0, hw=image.shape[:2], stride=16, noise=0.0, clutter=0.0,
            confidence=0.9)
        return [torch.from_numpy(f[None]).to(device) for f in (cif, caf, det)]
    return fields_batch


def drawn_multi_scale(port, predictor, files, card):
    """``multi_scale`` on the card with :func:`drawn_fields` for the
    forward, decoders at their defaults: every scale decodes the drawn
    people and boxes, and the merges keep each once and fewer than the
    scales gave; every CifHr call bit-equal to its plain version. Returns
    the CifHr launches."""
    merges = counted_merges(predictor)
    predictor.fields_batch = drawn_fields(predictor.device,
                                          predictor.head_metas)
    predictor.multi_scale = True
    try:
        with kept_cifhr_calls(port.cifhr_cuda) as calls:
            reset_launches(port)
            answers = [pred for pred, _, _ in predictor.images(files)]
            launches = read_launches(port)['cifhr_accumulate']
    finally:
        del predictor._merge_annotations, predictor._merge_detections
        del predictor.fields_batch
        predictor.multi_scale = False
    want = {'poses': len(DRAWN_PEOPLE), 'boxes': len(DRAWN_BOXES)}
    for kind, counts in merges.items():
        if len(counts) != len(files) or not all(
                given > kept >= want[kind] for given, kept in counts):
            raise AssertionError(f'mix (17b) drawn multi-scale: {kind} '
                                 f'(given, kept) per request {counts}')
    if [len(a) for a in answers] != [p[1] + b[1] for p, b in zip(
            merges['poses'], merges['boxes'])] or launches == 0:
        raise AssertionError(f'mix (17b) drawn multi-scale: answers '
                             f'{[len(a) for a in answers]}, merges {merges}, '
                             f'{launches} CifHr launches')
    check_kept_calls(port, calls, 'mix (17b) drawn multi-scale')
    log(f'mix (17b) drawn multi-scale: {len(DRAWN_PEOPLE)} people and '
        f'{len(DRAWN_BOXES)} boxes drawn at each of the '
        f'{len(predictor.multi_scale_factors)} scales; (given, kept) per '
        f'request poses {merges["poses"]}, boxes {merges["boxes"]}; '
        f'{launches} CifHr launches [{card}]')
    return launches


def engines_at_shapes(predictors, shapes, label):
    """Each engine's forward against the module graph's on the same card
    input, direct and mirrored (as hflip TTA forwards it), at every
    (H, W) that engine served ({engine: shapes}); TF32 off, ENGINE_TOL.
    These launches are not counted."""
    module = predictors['flax']
    rng = np.random.RandomState(4)
    for engine, served in shapes.items():
        errs = {}
        for hw in sorted(served):
            x = torch.from_numpy(rng.randn(1, *hw, 3).astype(
                np.float32)).to(module.device)
            for how, image in (('direct', x), ('mirrored', x.flip(2))):
                with no_tf32(), torch.inference_mode():
                    ref = module._forward(image)
                    errs[hw, how] = max(compare_fields(
                        predictors[engine]._forward(image), ref,
                        f'{label} {engine} at {hw} {how}', **ENGINE_TOL))
        log(f'{label}: {engine} vs the module graph at every served shape, '
            f'direct and mirrored, max abs err {errs} (TF32 off, rtol/atol '
            f'{ENGINE_TOL["rtol"]})')


def phase_mix_serve(port, ckpt, directory, device, card):
    """17b: the mix's checkpoint through ``Predictor(checkpoint=...)``:
    ``Multi`` of CifCaf and CifDet; hflip TTA fields against the CPU and
    between engines; the module graph and ``pallas`` serving plain, hflip
    TTA, multi-scale and both, ``dwpallas`` with hflip TTA (every CifHr
    call held bit for bit against its plain version, each engine against
    the module graph at every shape it served); ``pil_images`` and
    ``numpy_images`` against ``images``; prefetch at depth 2 against 0; a
    batch of CHUNK_BATCH chunked and whole. The decoders run with
    MIX_DECODER_FLAGS; then :func:`drawn_multi_scale`. Returns {kernel:
    launches}."""
    from openpifpaf_tpu_torch import decoder, predict
    from openpifpaf_tpu_torch.predictor import Predictor
    from torch_port_helpers import restored_statics

    with restored_statics(*decoder.DECODERS):
        predict.cli(['request.jpg', *MIX_DECODER_FLAGS])
        launches, files = mix_serve(port, ckpt, directory, device, card)
    launches['cifhr_accumulate'] += drawn_multi_scale(
        port, Predictor(checkpoint=ckpt, device=device), files, card)
    return launches


def mix_serve(port, ckpt, directory, device, card):
    import PIL.Image
    from openpifpaf_tpu_torch.predictor import Predictor

    predictors = {engine: Predictor(checkpoint=ckpt, device=device,
                                    backbone_engine=engine)
                  for engine in (*TTA_ENGINES, *TTA_ONLY_ENGINES)}
    module = predictors['flax']
    kinds = [type(d).__name__ for d in module.processor.decoders]
    if kinds != ['CifCaf', 'CifDet']:
        raise AssertionError(f'17b: decoders {kinds}')
    tta_fields_check(predictors, Predictor(checkpoint=ckpt, device='cpu'),
                     'mix (17b)')

    files = []
    for i, (image,) in enumerate(make_requests()[:TTA_REQUESTS]):
        path = os.path.join(directory, f'mix-request{i}.jpg')
        PIL.Image.fromarray(image).save(path, quality=95)
        files.append(path)
    launches = {}
    served = {}
    with kept_cifhr_calls(port.cifhr_cuda) as calls:
        reset_launches(port)
        for engine, kernel in TTA_ENGINES.items():
            counts, answers, served[engine] = serve_ways(
                port, predictors[engine], engine, kernel, files, TTA_WAYS,
                card, 'mix (17b)')
            if engine == 'flax':
                plain = answers['plain']
            for name, count in counts.items():
                launches[name] = launches.get(name, 0) + count
        for engine, kernel in TTA_ONLY_ENGINES.items():
            counts, _, served[engine] = serve_ways(
                port, predictors[engine], engine, kernel, files,
                ('hflip_tta',), card, 'mix (17b)')
            for name, count in counts.items():
                launches[name] = launches.get(name, 0) + count
        del served['flax']
        engines_at_shapes(predictors, served, 'mix (17b)')

        reset_launches(port)
        pil = [[a.json_data() for a in pred] for pred, _, _ in
               module.pil_images([PIL.Image.open(f).convert('RGB')
                                  for f in files])]
        arrays = [[a.json_data() for a in pred] for pred, _, _ in
                  module.numpy_images([np.asarray(PIL.Image.open(f)
                                                  .convert('RGB'))
                                       for f in files])]
        module.prefetch_depth = 0
        strict = [[a.json_data() for a in pred]
                  for pred, _, _ in module.images(files)]
        module.prefetch_depth = Predictor.prefetch_depth
        if not (plain == pil == arrays == strict and all(plain)):
            raise AssertionError(f'17b: images {plain}, pil_images {pil}, '
                                 f'numpy_images {arrays}, prefetch 0 '
                                 f'{strict}')
        launches['cifhr_accumulate'] += read_launches(port)[
            'cifhr_accumulate']
    log(f'mix (17b): pil_images, numpy_images and images without prefetch '
        f'answer as images with prefetch depth {Predictor.prefetch_depth} '
        f'({[len(a) for a in plain]} annotations)')
    shapes = check_kept_calls(port, calls, 'mix (17b)')
    log(f'mix (17b): CifHr maps (F, hr_h, hr_w, K) {sorted(shapes)}')

    rng = np.random.RandomState(3)
    batch = rng.randn(CHUNK_BATCH, *IMAGE_HW, 3).astype(np.float32)
    timed = {}
    with no_tf32():
        for chunk in (CHUNK_SIZE, 0):
            module.nn_chunk_size = chunk
            fields = module.fields_batch(batch)
            timed[chunk] = (fields, cuda_ms(
                lambda: module.fields_batch(batch), 3) / CHUNK_BATCH)
        module.nn_chunk_size = Predictor.nn_chunk_size
    errs = compare_fields(timed[0][0], timed[CHUNK_SIZE][0],
                          'mix (17b) chunked', **ENGINE_TOL)
    log(f'mix (17b): batch of {CHUNK_BATCH} at {IMAGE_HW}, chunks of '
        f'{CHUNK_SIZE} vs whole (TF32 off): max abs err per head {errs}; '
        f'NN {timed[CHUNK_SIZE][1]:.3f} ms per image chunked, '
        f'{timed[0][1]:.3f} ms whole (CUDA events, fields_batch) [{card}]')
    return launches, files


def phase_mix_eval(port, ckpt, directory, card):
    """17c: ``eval_cli.main --dataset cocokp --hflip-tta`` with the mix's
    checkpoint (``filter_and_extend`` keeps the cocokp heads) over
    MIX_EVAL_IMAGES synthetic images at long edge 641, decoders with
    MIX_DECODER_FLAGS: poses for every image, ten finite stats, nn and
    decoder ms per image, every CifHr call bit-equal to its plain version;
    the ground truth as predictions gives AP 1.0. Returns the CifHr
    launches."""
    from openpifpaf_tpu_torch import datasets, decoder, eval_cli
    from openpifpaf_tpu_torch.plugins.coco.cocokp import CocoKp
    from openpifpaf_tpu_torch.predictor import Predictor
    from torch_port_helpers import restored_statics, write_synthetic_coco

    ann_file, image_dir = write_synthetic_coco(
        os.path.join(directory, 'mix-eval'), n_images=MIX_EVAL_IMAGES,
        image_hw=TRAIN_IMAGE_HW, seed=1)
    out = os.path.join(directory, 'mix-eval', 'eval')
    tta_calls = []
    poses = []
    hflip = Predictor._hflip_tta_fields
    run_batch = Predictor._run_batch

    def counted(self, images):
        tta_calls.append(images.shape[0])
        return hflip(self, images)

    def counted_run(self, batch):
        for pred, gt_anns, meta in run_batch(self, batch):
            poses.append(len(pred))
            yield pred, gt_anns, meta

    Predictor._hflip_tta_fields = counted
    Predictor._run_batch = counted_run
    t0 = time.perf_counter()
    try:
        with kept_cifhr_calls(port.cifhr_cuda) as calls, restored_statics(
                *decoder.DECODERS, eval_cli.Evaluator,
                *datasets.datamodules().values()):
            reset_launches(port)
            eval_cli.main(['--dataset', 'cocokp', '--checkpoint', ckpt,
                           '--cocokp-val-annotations', ann_file,
                           '--cocokp-val-image-dir', image_dir,
                           '--eval-loader-warmup', '0', '--hflip-tta',
                           *MIX_DECODER_FLAGS, '--output', out])
            launches = read_launches(port)['cifhr_accumulate']
    finally:
        Predictor._hflip_tta_fields = hflip
        Predictor._run_batch = run_batch
    wall = time.perf_counter() - t0
    with open(out + '.stats.json') as f:
        stats = json.load(f)
    n_images = stats['n_images']
    if not (len(stats['stats']) == 10 and np.all(np.isfinite(stats['stats']))
            and n_images > 0 and len(tta_calls) == n_images
            and len(poses) == n_images and all(poses) and launches > 0):
        raise AssertionError(f'17c: stats {stats}, {len(tta_calls)} TTA '
                             f'forwards, poses per image {poses}, '
                             f'{launches} CifHr launches')
    per_image = {k: stats[k] / n_images * 1e3
                 for k in ('total_time', 'nn_time', 'decoder_time')}
    log(f'mix eval (17c): --hflip-tta over {n_images} images at long edge '
        f'641, per image total {per_image["total_time"]:.2f} ms, nn '
        f'{per_image["nn_time"]:.2f} ms, decoder '
        f'{per_image["decoder_time"]:.2f} ms (the first image included); '
        f'{launches} CifHr launches; poses per image {poses}; stats '
        f'{[round(v, 4) for v in stats["stats"]]}; whole command '
        f'{wall:.1f} s [{card}]')
    check_kept_calls(port, calls, 'mix eval (17c)')

    with restored_statics(CocoKp):
        CocoKp.eval_annotations = ann_file
        metric, = CocoKp().metrics()
    gt_stats = ground_truth_stats(metric, ann_file)
    if gt_stats[0] != 1.0:
        raise AssertionError(f'17c: ground truth as predictions {gt_stats}')
    log(f'mix eval (17c): the ground truth as predictions gives AP '
        f'{gt_stats[0]}, AR {gt_stats[5]}')
    return launches


def phase_mix(port, device, card):
    """Phase 17: (a)-(c); returns {kernel: launches} of (b) and (c)."""
    import tempfile
    from torch_port_helpers import write_synthetic_coco, \
        write_synthetic_cocodet

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as directory:
        kp_data = write_synthetic_coco(
            os.path.join(directory, 'coco'), n_images=TRAIN_IMAGES,
            image_hw=TRAIN_IMAGE_HW, seed=TRAIN_SEED)
        det_data = write_synthetic_cocodet(
            os.path.join(directory, 'cocodet'), n_images=TRAIN_IMAGES,
            image_hw=TRAIN_IMAGE_HW, seed=TRAIN_SEED)
        ckpt = phase_mix_train(kp_data, det_data, directory, card)
        launches = phase_mix_serve(port, ckpt, directory, device, card)
        launches['cifhr_accumulate'] += phase_mix_eval(port, ckpt,
                                                       directory, card)
    log(f'phase 17: launches {launches}; {time.perf_counter() - t0:.1f} s '
        f'[{card}]')
    return launches


#: phase 18: the reference-layout k16 (``torch_ref``, torch only) at full
#: width, random from REF_SEED with BatchNorm running statistics from
#: REF_BN_SEED and its confidence channels raised by REF_CONFIDENCE (so
#: that the decode keeps poses), saved as the reference saves checkpoints
REF_SEED = 0
REF_BN_SEED = 1
REF_CONFIDENCE = 2.0
REF_EPOCH = 3
#: 18a's engines and the backbone kernel each launches
REF_ENGINES = {'flax': None, 'pallas': 'shuffle_block',
               'dwpallas': 'depthwise_conv', 'folded': None}
#: the port's raw head outputs on the module graph against the
#: ``torch_ref`` forward on the card, float32 with TF32 off: max abs error
#: within this share of each head's largest value (engines: ENGINE_TOL)
REF_RTOL = 1e-5
#: 18a's decoder thresholds, lowered (as in
#: ``tests/test_torch_convert_torch.py``) so that the random weights keep
#: poses to compare; pose budgets of 16 bound the decode
REF_DECODER_FLAGS = ('--seed-threshold', '0.05', '--keypoint-threshold',
                     '0.05', '--instance-threshold', '0.001',
                     '--decoder-poses', '16', '--decoder-crowd-poses', '16')
APOLLO66_NAME = 'shufflenetv2k16-apollo-66'
APOLLO66_HEADS = ((66, 5), (108, 8))
#: 18c: fine-tuning steps from the pickle
REF_TRAIN_STEPS = 2


def reference_raw_outputs(ckpt, shell, device, card):
    """18a: the port's raw head outputs on each engine of REF_ENGINES,
    from ``Predictor(checkpoint=ckpt)``, against the reference-layout
    ``shell``'s own forward on the card (TF32 off)."""
    from openpifpaf_tpu_torch.predictor import Predictor

    x = test_image(device).permute(0, 3, 1, 2)
    with no_tf32(), torch.inference_mode():
        ref = list(shell.to(device)(x.contiguous()))
        shell.cpu()
        for engine in REF_ENGINES:
            p = Predictor(checkpoint=ckpt, device=device,
                          backbone_engine=engine)
            xc = x.contiguous(memory_format=torch.channels_last)
            features = p.model.base_net(xc) if p._backbone is None \
                else p._backbone(xc).float()
            raw = p.model.heads(features, train=True)
            label = f'reference raw outputs (18a) {engine}'
            if engine == 'flax':
                errs = [float((o - r).abs().max()) for o, r in zip(raw, ref)]
                shares = [e / float(r.abs().max()) for e, r in zip(errs, ref)]
                if not max(shares) <= REF_RTOL:
                    raise AssertionError(f'{label}: max abs err {errs}, '
                                         f'{shares} of the largest value, '
                                         f'want <= {REF_RTOL}')
                tol = f'{REF_RTOL} of the largest value; shares {shares}'
            else:
                errs = compare_fields(raw, ref, label, **ENGINE_TOL)
                tol = f'rtol/atol {ENGINE_TOL["rtol"]}'
            log(f'{label}: vs the torch_ref forward on the card, max abs '
                f'err per head {errs} (float32, TF32 off, tol {tol}) '
                f'[{card}]')
            del p


def phase_reference_serve(port, ckpt, files, directory, device, card):
    """18a: ``predict.main --checkpoint ref.pkl`` on each engine of
    REF_ENGINES (:func:`served_predict`); the poses of the module graph
    equal to those of the checkpoint ``migrate`` writes from the same
    pickle. Returns {kernel: launches}."""
    from openpifpaf_tpu_torch import migrate

    launches = {'cifhr_accumulate': 0}
    poses = {}
    for engine, kernel in REF_ENGINES.items():
        out = os.path.join(directory, f'predictions-{engine}')
        os.makedirs(out)
        counts, _ = served_predict(
            port, files, ['--checkpoint', ckpt, '--backbone-engine', engine,
                          '--json-output', out, *REF_DECODER_FLAGS],
            f'reference serve (18a) {engine}', ((17, 5), (19, 8)), card,
            kernel)
        for name, count in counts.items():
            launches[name] = launches.get(name, 0) + count
        poses[engine] = read_predictions(out)
        log(f'reference serve (18a) {engine}: poses per image '
            f'{[len(p) for p in poses[engine].values()]}')

    migrated = os.path.join(directory, 'migrated')
    migrate.main(['--checkpoint', ckpt, '--output', migrated])
    out = os.path.join(directory, 'predictions-migrated')
    os.makedirs(out)
    counts, _ = served_predict(
        port, files, ['--checkpoint', migrated, '--backbone-engine', 'flax',
                      '--json-output', out, *REF_DECODER_FLAGS],
        'migrated serve (18a)', ((17, 5), (19, 8)), card)
    launches['cifhr_accumulate'] += counts['cifhr_accumulate']
    if read_predictions(out) != poses['flax']:
        raise AssertionError('18a: the migrated checkpoint\'s poses differ '
                             'from the pickle\'s')
    n_poses = sum(len(p) for p in poses['flax'].values())
    if n_poses == 0:
        raise AssertionError('18a: the module graph kept no pose')
    log(f'migrated serve (18a): the {n_poses} poses of the 5 images equal '
        'the pickle\'s')
    return launches


def phase_reference_name(port, files, directory, card):
    """18b: ``predict --checkpoint shufflenetv2k16-apollo-66`` from a
    cache directory that holds the 66-keypoint pickle under the
    registered URL's file name (no hash suffix), with downloads refused;
    then a hash-suffixed name whose cached file fails its check raises.
    Returns the CifHr launches."""
    import urllib.request
    from openpifpaf_tpu_torch.models import factory
    from torch_port_helpers import reference_apollo66, \
        save_reference_checkpoint

    def refuse(url, filename):
        raise AssertionError(f'18b tried to download {url}')

    cache = os.path.join(directory, 'cache')
    os.makedirs(cache)
    saved = (os.environ.get('OPENPIFPAF_TPU_CACHE'),
             urllib.request.urlretrieve)
    os.environ['OPENPIFPAF_TPU_CACHE'] = cache
    urllib.request.urlretrieve = refuse
    try:
        url = factory.local_checkpoint_path(APOLLO66_NAME)
        local = os.path.join(cache, os.path.basename(url))
        save_reference_checkpoint(
            local, reference_apollo66(REF_SEED, REF_BN_SEED),
            epoch=REF_EPOCH)
        out = os.path.join(directory, 'predictions-apollo')
        os.makedirs(out)
        counts, _ = served_predict(
            port, files, ['--checkpoint', APOLLO66_NAME,
                          '--json-output', out],
            f'published name (18b) {APOLLO66_NAME}', APOLLO66_HEADS, card)
        for name, anns in read_predictions(out).items():
            if any(len(a['keypoints']) != 66 * 3 for a in anns):
                raise AssertionError(f'18b {name}: not 66 keypoints')

        hashed = factory.local_checkpoint_path('shufflenetv2k16')
        with open(local, 'rb') as src, \
                open(os.path.join(cache, os.path.basename(hashed)),
                     'wb') as dst:
            dst.write(src.read())
        try:
            factory.resolve_checkpoint('shufflenetv2k16')
        except ValueError as e:
            if 'hash mismatch' not in str(e):
                raise
            log(f'published name (18b) shufflenetv2k16: a cached file that '
                f'fails its hash raises: {e}')
        else:
            raise AssertionError('18b: a file that fails its hash check '
                                 'resolved')
    finally:
        urllib.request.urlretrieve = saved[1]
        if saved[0] is None:
            del os.environ['OPENPIFPAF_TPU_CACHE']
        else:
            os.environ['OPENPIFPAF_TPU_CACHE'] = saved[0]
    return counts['cifhr_accumulate']


def phase_reference_train(ckpt, directory, card):
    """18c: ``train.main --checkpoint ref.pkl`` for REF_TRAIN_STEPS steps
    on phase 11's synthetic cocokp set (batch 8, 385 px, float32): the
    run starts at the pickle's epoch, every loss is finite, the step
    times (CUDA events)."""
    from openpifpaf_tpu_torch import train
    from openpifpaf_tpu_torch.training.trainer import Trainer
    from torch_port_helpers import write_synthetic_coco

    data = write_synthetic_coco(
        os.path.join(directory, 'coco'), n_images=TRAIN_BATCH * 2,
        image_hw=TRAIN_IMAGE_HW, seed=TRAIN_SEED)
    out = os.path.join(directory, 'finetuned', 'model')
    os.makedirs(os.path.dirname(out))
    argv = train_flags(data, out, '--checkpoint', ckpt)
    for flag, value in (('--epochs', REF_EPOCH + 1),
                        ('--train-batches', REF_TRAIN_STEPS),
                        ('--val-batches', 1)):
        argv[argv.index(flag) + 1] = str(value)
    events = []
    original = timed_train_steps(Trainer, events)
    t0 = time.perf_counter()
    try:
        train.main(argv)
    finally:
        Trainer.train_step = original
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train_lines, val_lines = read_train_log(out + '.log')
    losses = [line['loss'] for line in train_lines + val_lines]
    if [line['epoch'] for line in train_lines] != [REF_EPOCH] * \
            REF_TRAIN_STEPS or len(val_lines) != 1 \
            or not np.all(np.isfinite(losses)):
        raise AssertionError(f'18c: train lines {train_lines}, val lines '
                             f'{val_lines}')
    with open(out + '.json') as f:
        meta = json.load(f)
    if meta['epoch'] != REF_EPOCH + 1 or meta['base_name'] != \
            'shufflenetv2k16':
        raise AssertionError(f'18c: checkpoint meta {meta}')
    step_ms = [s.elapsed_time(e) for s, e in events]
    log(f'fine-tune (18c): {len(step_ms)} steps from the pickle\'s epoch '
        f'{REF_EPOCH} (written as epoch {meta["epoch"]}), step '
        f'{[round(ms, 2) for ms in step_ms]} ms (CUDA events; the first '
        f'picks cuDNN\'s algorithms), losses {[round(x, 1) for x in losses]}'
        f', whole run {wall:.1f} s [{card}]')


def phase_reference_count_ops(ckpt, card):
    """18d: ``count_ops.main --checkpoint ref.pkl`` on the card."""
    from openpifpaf_tpu_torch import count_ops

    t0 = time.perf_counter()
    gflops, mparams = count_ops.main(['--checkpoint', ckpt])
    if not (gflops > 0 and mparams > 0):
        raise AssertionError(f'18d: {gflops} GFLOPs, {mparams} M parameters')
    log(f'count_ops (18d): shufflenetv2k16 with the cocokp heads, 641x641: '
        f'{gflops:.4f} GFLOPs, {mparams:.6f} million parameters, '
        f'{time.perf_counter() - t0:.1f} s [{card}]')


def phase_reference(port, device, card):
    """Phase 18: (a)-(d); returns {kernel: launches} of (a) and (b)."""
    import tempfile
    from torch_port_helpers import raise_confidences, reference_k16, \
        save_reference_checkpoint

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as directory:
        shell = raise_confidences(reference_k16(REF_SEED, REF_BN_SEED),
                                  REF_CONFIDENCE)
        ckpt = save_reference_checkpoint(
            os.path.join(directory, 'ref.pkl'), shell, epoch=REF_EPOCH,
            basenet='shufflenetv2k16')
        files = write_requests(directory)
        reference_raw_outputs(ckpt, shell, device, card)
        launches = phase_reference_serve(port, ckpt, files, directory,
                                         device, card)
        launches['cifhr_accumulate'] += phase_reference_name(
            port, files, directory, card)
        phase_reference_train(ckpt, directory, card)
        phase_reference_count_ops(ckpt, card)
    log(f'phase 18: launches {launches}; {time.perf_counter() - t0:.1f} s '
        f'[{card}]')
    return launches


#: phase 19: drawing. (a) serves the main path's requests through
#: ``predict.main`` on these engines (and the backbone kernel each
#: launches), with REF_DECODER_FLAGS, the show flags of DRAW_FLAGS and,
#: where matplotlib is installed, ``-o``, ``--save-all`` and the debug
#: plots of DRAW_DEBUG_INDICES
DRAW_ENGINES = {'pallas': 'shuffle_block', 'dwpallas': 'depthwise_conv'}
DRAW_FLAGS = ('--show-decoding-order', '--show-frontier-order',
              '--show-joint-scales')
#: kept small: ``Caf.predicted`` draws one quiver per requested field
DRAW_DEBUG_INDICES = ('cif:0', 'caf:0')
#: figures that each decode saves under ``--save-all`` with
#: DRAW_DEBUG_INDICES: the confidence and the regression plot of cif:0 and
#: of caf:0 (``Cif.predicted`` and ``Caf.predicted`` of batch element 0)
DRAW_FIGURES_PER_DECODE = 4
DRAW_EVAL_IMAGES = 4
#: the state that the predict CLI's ``configure`` must give for
#: ``torch_port_helpers.SHOW_FLAGS`` and ``DEBUG_INDICES_FLAGS``
DRAW_PARSED = {
    'KeypointPainter': {
        'textbox_alpha': 0.25, 'text_color': 'black', 'font_size': 11,
        'monocolor_connections': True, 'line_width': 4,
        'solid_threshold': 0.7, 'show_frontier_order': True,
        'show_box': True, 'show_joint_scales': True,
        'show_joint_confidences': True, 'show_decoding_order': True,
        'show_only_decoded_connections': True},
    'AnimationFrame': {'video_fps': 25.0, 'video_dpi': 120.0},
    'SAVE_ALL': {'dir': 'all/'},
    'CONFIG': {'out_file_extension': 'png', 'image_min_dpi': 80.0,
               'white_overlay': 0.5},
    'all_indices': [('cif', 0, 'all'), ('caf', 1, 'confidence')],
}


def has_matplotlib():
    import importlib.util
    return importlib.util.find_spec('matplotlib') is not None


def posed_k16_checkpoint(directory):
    """The full-width shufflenetv2k16 with the cocokp heads, random from
    seed 0, its heads made to decode to whole people
    (``torch_port_helpers.posed_model``), saved as a checkpoint of the
    port."""
    from openpifpaf_tpu_torch.models import factory
    from openpifpaf_tpu_torch.plugins.coco.constants import cocokp_head_metas
    from torch_port_helpers import posed_model

    model = posed_model(factory.Factory().from_scratch(
        cocokp_head_metas(), generator=torch.Generator().manual_seed(0)))
    path = os.path.join(directory, 'posed-k16')
    save_checkpoint(path, model, 'shufflenetv2k16')
    return path


@contextlib.contextmanager
def decoded_annotations():
    """Within: the annotations that ``CifCaf``'s decodes give (pipelined
    or strict: ``batch_decode_deferred``), of every image, are appended to
    the list this yields."""
    from openpifpaf_tpu_torch.decoder import CifCaf

    decoded = []
    batch_decode_deferred = CifCaf.batch_decode_deferred

    def kept(self, *args, **kwargs):
        materialize = batch_decode_deferred(self, *args, **kwargs)

        def kept_materialize():
            out = materialize()
            decoded.extend(ann for anns in out for ann in anns)
            return out

        return kept_materialize

    CifCaf.batch_decode_deferred = kept
    try:
        yield decoded
    finally:
        CifCaf.batch_decode_deferred = batch_decode_deferred


@contextlib.contextmanager
def timed_drawings():
    """Within: each ``show.AnnotationPainter.annotations`` call appends
    its annotations and, when it drew into a ``show.image_canvas``, the
    host ms from the painter's start to the end of the canvas (its
    ``savefig`` and close) to the list this yields."""
    from openpifpaf_tpu_torch import show

    drawings = []
    annotations = show.AnnotationPainter.annotations
    image_canvas = show.image_canvas

    def painted(self, ax, anns, **kwargs):
        drawings.append({'anns': list(anns), 'start': time.perf_counter()})
        return annotations(self, ax, anns, **kwargs)

    @contextlib.contextmanager
    def timed_canvas(*args, **kwargs):
        with image_canvas(*args, **kwargs) as ax:
            yield ax
        if drawings and 'ms' not in drawings[-1]:
            drawings[-1]['ms'] = (time.perf_counter()
                                  - drawings[-1]['start']) * 1e3

    show.AnnotationPainter.annotations = painted
    show.image_canvas = timed_canvas
    try:
        yield drawings
    finally:
        show.AnnotationPainter.annotations = annotations
        show.image_canvas = image_canvas


def check_decoding_orders(annotations, label):
    """Every annotation has its decoding order
    (``torch_port_helpers.assert_decoding_order``: a growth from one seed
    that reaches every visible joint). Returns (annotations, those with at
    least one edge)."""
    from torch_port_helpers import assert_decoding_order

    with_edges = 0
    for i, ann in enumerate(annotations):
        try:
            with_edges += assert_decoding_order(ann) > 0
        except AssertionError as e:
            raise AssertionError(f'{label} annotation {i}: decoding order '
                                 f'{e}') from e
    if not annotations or not with_edges:
        raise AssertionError(f'{label}: {len(annotations)} annotations, '
                             f'{with_edges} with a decoding order')
    return len(annotations), with_edges


def phase_draw_serve(port, ckpt, files, directory, card, drawing):
    """19a: ``predict.main`` over the main path's requests as 481x641
    JPEGs (:func:`served_predict`: fields, one CifHr launch per image per
    tier, each call bit-equal to its plain version, the engine's kernel
    FORWARD_LAUNCHES times per forward) on each engine of DRAW_ENGINES
    with DRAW_FLAGS; every annotation's decoding order. With ``drawing``
    (matplotlib installed): ``-o``, ``--save-all`` and ``--debug-indices``
    too, every ``-o`` image of the input's size, DRAW_FIGURES_PER_DECODE
    figures per decode, and the draw ms per image (host clock, from the
    painter to the end of the ``savefig``). Returns {kernel: launches}."""
    from torch_port_helpers import drawing_statics

    launches = {'cifhr_accumulate': 0}
    for engine, kernel in DRAW_ENGINES.items():
        label = f'drawing (19a) {engine}'
        out = os.path.join(directory, f'drawn-{engine}')
        figures = os.path.join(directory, f'figures-{engine}')
        os.makedirs(out)
        argv = ['--checkpoint', ckpt, '--backbone-engine', engine,
                *DRAW_FLAGS, *REF_DECODER_FLAGS]
        if drawing:
            argv += ['-o', out, '--save-all', figures,
                     '--debug-indices', *DRAW_DEBUG_INDICES]
        else:
            argv += ['--json-output', out]
        with drawing_statics('openpifpaf_tpu_torch'), \
                decoded_annotations() as decoded, \
                (timed_drawings() if drawing
                 else contextlib.nullcontext([])) as drawings:
            counts, records = served_predict(
                port, files, argv, label, ((17, 5), (19, 8)), card, kernel)
        for name, count in counts.items():
            launches[name] = launches.get(name, 0) + count
        n_anns, with_edges = check_decoding_orders(decoded, label)
        images = [f for request in files for f in request]
        warm = records[1:3]
        line = (f'{label}: {n_anns} annotations, each with its decoding '
                f'order ({with_edges} with edges; the rest are a seed '
                'alone); NN '
                f'{np.mean([r["nn_ms"] for r in warm]):.3f} ms/image, '
                f'decode {np.mean([r["decode_ms"] for r in warm]):.2f} '
                'ms/image (the 2 warm batch-1 requests)')
        if drawing:
            import PIL.Image
            sizes = [PIL.Image.open(os.path.join(
                out, os.path.basename(f) + '.predictions.jpg')).size
                for f in images]
            if sizes != [IMAGE_HW[::-1]] * len(images):
                raise AssertionError(f'{label}: -o image sizes {sizes}, '
                                     f'want {IMAGE_HW[::-1]}')
            saved = sorted(os.listdir(figures))
            want = DRAW_FIGURES_PER_DECODE * len(records)
            if len(saved) != want:
                raise AssertionError(f'{label}: {len(saved)} figures under '
                                     f'--save-all for {len(records)} '
                                     f'decodes, want {want}')
            draw_ms = [d['ms'] for d in drawings]
            if len(draw_ms) != len(images):
                raise AssertionError(f'{label}: {len(draw_ms)} drawings '
                                     f'for {len(images)} images')
            line += (f', draw {np.mean(draw_ms[1:]):.2f} ms/image (host '
                     f'clock, painter to savefig, images 2-{len(images)}; '
                     f'all {[round(ms, 2) for ms in draw_ms]}); '
                     f'{len(images)} -o images of {IMAGE_HW[1]}x'
                     f'{IMAGE_HW[0]}, {len(saved)} --save-all figures for '
                     f'{len(records)} decodes')
        log(f'{line} [{card}]')
    return launches


def phase_draw_golden(port, directory, device, card, drawing):
    """19b: the golden 3-person scene (its decoding-order entry: weakened
    CAF, ``--decoder-seeds 1024``) decoded on the card by a decoder built
    after ``show.configure`` of ``--show-decoding-order
    --show-frontier-order``: the JAX poses within the gate, its
    ``decoding_order`` and ``frontier_order`` equal to JAX's, every CifHr
    call bit-equal to its plain version; with ``drawing``, drawn with
    both overlays."""
    import argparse
    from openpifpaf_tpu_torch import show
    from torch_port_helpers import GOLDEN_SPARSE_FLAGS, GOLDEN_STRIDE, \
        assert_pose_gate, drawing_statics, golden_inputs, order_rows, \
        port_decoder, pose_rows

    golden = np.load(GOLDEN)
    key = 'sparse_decoding_order'
    with drawing_statics('openpifpaf_tpu_torch'):
        parser = argparse.ArgumentParser()
        show.cli(parser)
        show.configure(parser.parse_args(['--show-decoding-order',
                                          '--show-frontier-order']))
        decoder = port_decoder(GOLDEN_STRIDE, GOLDEN_SPARSE_FLAGS)
        if not decoder.config.export_decoding_order:
            raise AssertionError('19b: the show flags did not switch on the '
                                 'decoding-order export')
        fields, _ = golden_inputs(golden, 'sparse', 'decoding_order', key,
                                  device)
        with kept_cifhr_calls(port.cifhr_cuda) as calls:
            anns = decoder.batch_decode(fields)[0]
        assert_pose_gate(list(pose_rows(anns)), list(golden[f'{key}_poses']))
        np.testing.assert_array_equal(order_rows(anns),
                                      golden[f'{key}_order'])
        check_kept_calls(port, calls, 'golden order (19b)')
        line = (f'golden order (19b): {len(anns)} poses match the JAX decode,'
                ' decoding and frontier orders equal to JAX\'s '
                f'({sum(len(a.decoding_order) for a in anns)} edges, '
                f'{sum(len(a.frontier_order) for a in anns)} frontier edges)')
        if drawing:
            import PIL.Image
            path = os.path.join(directory, 'golden-order.png')
            start = time.perf_counter()
            with show.image_canvas(np.full(HR_SHAPE + (3,), 128,
                                           np.uint8), path,
                                   show=False) as ax:
                show.AnnotationPainter().annotations(ax, anns)
            draw_ms = (time.perf_counter() - start) * 1e3
            if PIL.Image.open(path).size != HR_SHAPE[::-1]:
                raise AssertionError(f'19b: {path} of size '
                                     f'{PIL.Image.open(path).size}')
            line += f'; drawn in {draw_ms:.2f} ms (host clock)'
    log(f'{line} [{card}]')


def phase_draw_video(port, ckpt, directory, card):
    """19c: ``video.main --video-output`` over phase 13's VIDEO_FRAMES
    JPEGs with the posed k16: an mp4 where matplotlib has ``ffmpeg``,
    else one JPEG per frame under JAX's names, each of the input's size;
    every CifHr call bit-equal to its plain version. Returns the CifHr
    launches."""
    import matplotlib.animation
    import PIL.Image
    from openpifpaf_tpu_torch import decoder, video
    from torch_port_helpers import drawing_statics, restored_statics

    frames = os.path.join(directory, 'frames')
    os.makedirs(frames)
    names = write_video_frames(frames)
    out = os.path.join(directory, 'video', 'drawn.mp4')
    os.makedirs(os.path.dirname(out))
    ffmpeg = 'ffmpeg' in matplotlib.animation.writers.list()
    start = time.perf_counter()
    reset_launches(port)
    with drawing_statics('openpifpaf_tpu_torch'), \
            restored_statics(*decoder.DECODERS, decoder.TrackBase), \
            kept_cifhr_calls(port.cifhr_cuda) as calls:
        video.main(['--source', ','.join(names), '--checkpoint', ckpt,
                    '--video-output', out, '--quiet', *REF_DECODER_FLAGS])
    launches = read_launches(port)['cifhr_accumulate']
    wall = time.perf_counter() - start
    if ffmpeg:
        if not os.path.getsize(out) > 0:
            raise AssertionError(f'19c: {out} is empty')
        wrote = f'an mp4 through matplotlib\'s ffmpeg writer ({out})'
    else:
        written = sorted(os.listdir(os.path.dirname(out)))
        want = [f'drawn.mp4.{i:06d}.jpg' for i in range(1, VIDEO_FRAMES + 1)]
        sizes = {PIL.Image.open(os.path.join(os.path.dirname(out), n)).size
                 for n in written}
        if written != want or sizes != {IMAGE_HW[::-1]}:
            raise AssertionError(f'19c: wrote {written} of sizes {sizes}')
        wrote = (f'no ffmpeg among matplotlib\'s writers: {len(written)} '
                 f'per-frame JPEGs {written[0]} ... {written[-1]}')
    if launches == 0 or launches != len(calls):
        raise AssertionError(f'19c: {launches} CifHr launches, {len(calls)} '
                             'calls')
    check_kept_calls(port, calls, 'video (19c)')
    log(f'video (19c): {VIDEO_FRAMES} frames drawn, {wrote}; {launches} '
        f'CifHr launches; whole run {wall:.1f} s [{card}]')
    return launches


def phase_draw_eval(port, ckpt, directory, card):
    """19d: ``eval_cli.main --eval-show-final-image
    --eval-show-final-ground-truth`` with the posed k16 over
    DRAW_EVAL_IMAGES synthetic images: ``cocokp-eval-final-image.png`` in
    the working directory, the predictions and then the ground truth (in
    grey) drawn into it; every CifHr call bit-equal to its plain version.
    Returns the CifHr launches."""
    import PIL.Image
    from openpifpaf_tpu_torch import datasets, decoder, eval_cli
    from torch_port_helpers import drawing_statics, restored_statics, \
        write_synthetic_coco

    ann_file, image_dir = write_synthetic_coco(
        os.path.join(directory, 'draw-eval'), n_images=DRAW_EVAL_IMAGES,
        image_hw=TRAIN_IMAGE_HW, seed=TRAIN_SEED)
    cwd = os.getcwd()
    os.chdir(directory)
    start = time.perf_counter()
    try:
        with drawing_statics('openpifpaf_tpu_torch'), \
                timed_drawings() as drawings, \
                kept_cifhr_calls(port.cifhr_cuda) as calls, \
                restored_statics(*decoder.DECODERS, eval_cli.Evaluator,
                                 *datasets.datamodules().values()):
            reset_launches(port)
            eval_cli.main(['--dataset', 'cocokp', '--checkpoint', ckpt,
                           '--cocokp-val-annotations', ann_file,
                           '--cocokp-val-image-dir', image_dir,
                           '--eval-loader-warmup', '0',
                           '--eval-show-final-image',
                           '--eval-show-final-ground-truth',
                           *REF_DECODER_FLAGS, '--output',
                           os.path.join(directory, 'draw-eval', 'eval')])
            launches = read_launches(port)['cifhr_accumulate']
    finally:
        os.chdir(cwd)
    wall = time.perf_counter() - start
    path = os.path.join(directory, 'cocokp-eval-final-image.png')
    size = PIL.Image.open(path).size
    n = [len(d['anns']) for d in drawings]
    if len(n) != 2 or not n[1] or launches == 0:
        raise AssertionError(f'19d: drawings of {n} annotations, {launches} '
                             'CifHr launches')
    check_kept_calls(port, calls, 'eval (19d)')
    log(f'eval (19d): {os.path.basename(path)} of {size[0]}x{size[1]} with '
        f'{n[0]} predictions and {n[1]} ground-truth annotations in grey; '
        f'{launches} CifHr launches; whole run {wall:.1f} s [{card}]')
    return launches


def phase_draw_parse(card):
    """19: every flag of show/cli.py and
    visualizer/cli.py parsed by the predict CLI configures the state that
    DRAW_PARSED says; video's and eval's drawing flags parse."""
    import importlib
    from openpifpaf_tpu_torch import datasets, decoder, eval_cli, predict, \
        show, video, visualizer
    from torch_port_helpers import DEBUG_INDICES_FLAGS, SHOW_FLAGS, \
        drawing_statics, restored_statics

    canvas = importlib.import_module('openpifpaf_tpu_torch.show.canvas')
    with drawing_statics('openpifpaf_tpu_torch'), \
            restored_statics(*decoder.DECODERS, decoder.TrackBase,
                             *datasets.datamodules().values()):
        args = predict.cli(['request.jpg', '-o', 'out/', *SHOW_FLAGS,
                            *DEBUG_INDICES_FLAGS])
        got = {
            'KeypointPainter': {k: getattr(show.KeypointPainter, k)
                                for k in DRAW_PARSED['KeypointPainter']},
            'AnimationFrame': {k: getattr(show.AnimationFrame, k)
                               for k in DRAW_PARSED['AnimationFrame']},
            'SAVE_ALL': {'dir': canvas.SAVE_ALL['dir']},
            'CONFIG': {k: canvas.CONFIG[k] for k in DRAW_PARSED['CONFIG']},
            'all_indices': visualizer.Base.all_indices,
        }
        if got != DRAW_PARSED or args.image_output != 'out/' \
                or not args.show or not decoder.CifCaf.export_decoding_order:
            raise AssertionError(f'19: the predict CLI configured {got}')
        v = video.cli(['--source', 'a.jpg', '--video-output',
                       '--separate-debug-ax', '--device', 'cpu'])
        s = video.cli(['--source', 'a.jpg', '--show', '--device', 'cpu'])
        e = eval_cli.cli(['--eval-show-final-image',
                          '--eval-show-final-ground-truth'])
    if v.video_output != 'a.jpg.pifpaf.mp4' or not v.separate_debug_ax \
            or not s.show or not (e.eval_show_final_image
                                  and e.eval_show_final_ground_truth):
        raise AssertionError(f'19: video {v}, {s}, eval {e}')
    log('drawing flags (19): the predict CLI parsed -o and every show and '
        'visualizer flag into the painters\', '
        'canvases\', visualizers\' and decoder\'s state; video '
        '--video-output/--separate-debug-ax/--show and eval '
        '--eval-show-final-image/--eval-show-final-ground-truth parse '
        f'[{card}]')


def phase_drawing(port, device, card):
    """Phase 19: (a)-(d) where matplotlib is installed, without it (a)'s
    decode and its checks and (b)'s orders; then the CLIs' parse of every
    drawing flag. Returns {kernel: launches} of (a), (c) and (d)."""
    import tempfile

    drawing = has_matplotlib()
    if drawing:
        import matplotlib
        matplotlib.use('Agg')
    else:
        log('drawing (19): matplotlib is absent on this machine: nothing is '
            'drawn here; phase 19 runs the decode of (a), the orders of (b) '
            'and the parse of every drawing flag, and the drawing is held '
            'only by the CPU tests')
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as directory:
        ckpt = posed_k16_checkpoint(directory)
        files = write_requests(directory)
        launches = phase_draw_serve(port, ckpt, files, directory, card,
                                    drawing)
        phase_draw_golden(port, directory, device, card, drawing)
        if drawing:
            launches['cifhr_accumulate'] += phase_draw_video(
                port, ckpt, directory, card)
            launches['cifhr_accumulate'] += phase_draw_eval(
                port, ckpt, directory, card)
        phase_draw_parse(card)
    log(f'phase 19: launches {launches}; {time.perf_counter() - t0:.1f} s '
        f'[{card}]')
    return launches


#: phase 20: deployment. (a) exports phase 19's posed k16 with ``python -m
#: openpifpaf_tpu_torch.export`` (its fields program, and its forward and
#: decode as one program) at the default 481x641 input and runs both on
#: the phase's images, then the decode alone on posed, drawn and sparse
#: fields; (b) serves those images as JPEGs through
#: ``predict --long-edge`` on these engines, on the native loader and on
#: PIL; (c) trains PROFILE_STEPS steps with ``--profile`` and builds
#: CACHE_SOURCES twice with ``--xla-compilation-cache``; (d) ``logs
#: --print-last`` of (c)'s training log
EXPORT_TIMED_PASSES = 1
NATIVE_LONG_EDGE = 641
NATIVE_ENGINES = DRAW_ENGINES
PROFILE_STEPS = 2
CACHE_SOURCES = ('cifhr.cu',)
#: ``tests/test_native_io.py::test_close_to_pil``'s gate: the mean absolute
#: difference of the normalised native batch from the PIL path's
NATIVE_PIL_MEAN_ATOL = 0.5
#: the decode's fixpoints, in the order one decode runs them
FIXPOINTS = ('seed_nms', 'seed_rank_dedup', 'nms_keypoints')
#: alternating pairs of the eager decode with each form of the growth
GROW_PAIRS = 2
#: 20a's drawn request: (centre x, height) of each person, as fractions of
#: the 481x641 image, drawn by the port's encoders into its fields
EXPORT_PEOPLE = ((0.2, 0.7), (0.5, 0.5), (0.8, 0.6))
#: the include directories searched for ``jpeglib.h`` (the loader's header)
JPEG_INCLUDES = ('/usr/include', '/usr/local/include',
                 '/usr/include/x86_64-linux-gnu')


def pil_preprocess(long_edge):
    """The port Predictor's preprocess of a file at ``long_edge`` (its PIL
    path)."""
    from openpifpaf_tpu_torch import transforms
    from openpifpaf_tpu_torch.predictor import _pil_image

    return transforms.Compose([
        transforms.ImageTransform(_pil_image),
        transforms.NormalizeAnnotations(),
        transforms.RescaleAbsolute(long_edge) if long_edge else None,
        transforms.CenterPadTight(16),
        transforms.EVAL_TRANSFORM,
    ])


def phase_images(files, device):
    """The JPEGs of ``files`` (one list per request) as (1, H, W, 3)
    float32 tensors on ``device``, preprocessed as the Predictor does at
    their own size."""
    import PIL.Image

    preprocess = pil_preprocess(None)
    images = []
    for path in (f for request in files for f in request):
        with open(path, 'rb') as f:
            image, _, _ = preprocess(PIL.Image.open(f).convert('RGB'), [],
                                     {'dataset_index': 0})
        images.append(torch.from_numpy(np.asarray(image, np.float32))[None]
                      .to(device))
    return images


def run_export(ckpt, outfile, *extra, timeout=600, nice=()):
    """``python -m openpifpaf_tpu_torch.export --checkpoint ckpt`` on the
    card in a process of its own (under ``nice``, a command prefix);
    returns its wall seconds."""
    start = time.perf_counter()
    done = subprocess.run(
        [*nice, sys.executable, '-m', 'openpifpaf_tpu_torch.export',
         '--checkpoint', ckpt, '--outfile', outfile, *extra], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=timeout, check=False)
    wall = time.perf_counter() - start
    if done.returncode != 0 or \
            done.stdout.strip().splitlines()[-1:] != [f'wrote {outfile}']:
        raise AssertionError(f'export {extra} failed ({done.returncode}):\n'
                             f'{done.stdout[-2000:]}{done.stderr[-4000:]}')
    return wall


@contextlib.contextmanager
def kept_launches(cifhr_cuda):
    """Within: each launch of the CifHr operator's CUDA implementation
    (``cifhr_cuda.launch_counted``, what an exported program calls) keeps
    its cells, keywords and map (cloned) in the list this yields."""
    launch_counted = cifhr_cuda.launch_counted
    calls = []

    def kept(x, y, sigma, w, **kw):
        out = launch_counted(x, y, sigma, w, **kw)
        calls.append(((x.clone(), y.clone(), sigma.clone(), w.clone()), kw,
                      out.clone()))
        return out

    cifhr_cuda.launch_counted = kept
    try:
        yield calls
    finally:
        cifhr_cuda.launch_counted = launch_counted


@contextlib.contextmanager
def counted_rounds():
    """Within: the decode's fixpoints run as the host loop they replaced,
    each appending its number of rounds to the list this yields."""
    from openpifpaf_tpu_torch.ops import nms, seeds

    fixpoint = seeds._fixpoint
    rounds = []

    def counted(step, start, *operands):
        state, n = start, 0
        while True:
            new = step(state, *operands)
            n += 1
            if torch.equal(new, state):
                rounds.append(n)
                return new
            state = new

    seeds._fixpoint = nms._fixpoint = counted
    try:
        yield rounds
    finally:
        seeds._fixpoint = nms._fixpoint = fixpoint


def check_program_calls(port, calls, launches, n_images, label):
    """One launch of the CifHr kernel per image, each kept map
    (:func:`kept_launches`) bit-equal to its plain version."""
    if launches != n_images or len(calls) != n_images:
        raise AssertionError(f'{label}: {launches} CifHr launches, '
                             f'{len(calls)} kept, for {n_images} images')
    for i, (cells, kw, out) in enumerate(calls):
        plain = port.cifhr.accumulate_dense(*cells, **kw)
        if not torch.equal(out, plain):
            raise AssertionError(
                f'{label} CifHr call {i}: kernel vs plain not bit-equal, '
                f'max abs err {float((out - plain).abs().max())}')


def event_ms(fn):
    """Milliseconds of one call of ``fn`` between two CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def lane_poses(poses):
    """The (n, n_kp, 4) poses of image 0 that have a visible joint."""
    poses = poses[0].cpu().numpy()
    return poses[(poses[:, :, 0] > 0).any(axis=1)]


#: 20a's three exports, each in a process of its own
EXPORTS = ('fields', 'decode', 'decode-only')


def export_field_hw(stride):
    """The fields' (H, W) of an IMAGE_HW input at ``stride``."""
    return tuple((n - 1) // stride + 1 for n in IMAGE_HW)


def start_exports(pool, ckpt, directory, device):
    """Submit 20a's three exports of ``ckpt`` to ``pool``, side by side:
    the fields program and the forward with the decode (the export CLI)
    and the decode alone at phase 19's k16's stride 16
    (:func:`run_decode_export`); {name: future of its wall seconds}."""
    paths = {name: os.path.join(directory, f'k16-{name}.pt2')
             for name in EXPORTS}
    return {
        'fields': pool.submit(run_export, ckpt, paths['fields']),
        'decode': pool.submit(run_export, ckpt, paths['decode'],
                              '--with-decoder'),
        'decode-only': pool.submit(run_decode_export, paths['decode-only'],
                                   device, 16, export_field_hw(16))}


def phase_export(port, ckpt, images, directory, device, card, exports):
    """20a: the fields program within 1e-4 of each head's largest value of
    the eager module graph (TF32 off); the decode program's poses within
    the pose gate of the eager ``build_cifcaf_decoder`` on the card (and
    whether they are bit-equal); every CifHr call of the program bit-equal
    to its plain version; times, device ops, syncs and fixpoint rounds;
    then :func:`phase_export_decode`. Returns the CifHr launches of the
    programs."""
    from openpifpaf_tpu_torch.ops.decode_cifcaf import build_cifcaf_decoder
    from openpifpaf_tpu_torch.training import checkpoint
    from torch_port_helpers import assert_pose_gate

    model, _ = checkpoint.load_shell(ckpt)
    model = model.to(device).eval()
    cif_meta, caf_meta = model.head_metas[:2]
    decode = build_cifcaf_decoder(stride=cif_meta.stride,
                                  skeleton=caf_meta.skeleton,
                                  n_keypoints=len(cif_meta.keypoints))
    with torch.no_grad():
        field_hw = tuple(model(images[0])[0].shape[-2:])
    if field_hw != export_field_hw(cif_meta.stride):
        raise AssertionError(f'export (20a): fields {field_hw}, the '
                             f'decode-only program exported at '
                             f'{export_field_hw(cif_meta.stride)}')
    paths = {name: os.path.join(directory, f'k16-{name}.pt2')
             for name in EXPORTS}
    walls = {name: future.result() for name, future in exports.items()}
    for name in ('fields', 'decode'):
        log(f'export (20a) {name}: python -m openpifpaf_tpu_torch.export '
            f'--checkpoint posed-k16{" --with-decoder" * (name == "decode")}'
            f' at {IMAGE_HW[0]}x{IMAGE_HW[1]}: {walls[name]:.1f} s wall '
            '(process start, checkpoint load, trace, save; beside the '
            f'other two exports and (b)-(d)), {os.path.getsize(paths[name])} '
            'bytes '
            f'[{card}]')
    programs = {name: torch.export.load(paths[name]).module()
                for name in ('fields', 'decode')}

    errs, bit_fields = [], True
    with no_tf32(), torch.no_grad():
        for i, image in enumerate(images):
            for o, r in zip(programs['fields'](image), model(image)):
                err = float((o - r).abs().max())
                if not err <= 1e-4 * float(r.abs().max()):
                    raise AssertionError(f'export (20a) fields of image {i}:'
                                         f' max abs err {err}')
                errs.append(err / float(r.abs().max()))
                bit_fields &= torch.equal(o, r)
    log(f'export (20a) fields program: {len(images)} images within '
        f'{max(errs):.3g} of each head\'s largest value of the eager module '
        f'graph (gate 1e-4, TF32 off), bit-equal {bit_fields} [{card}]')

    reset_launches(port)
    with kept_launches(port.cifhr_cuda) as calls, torch.no_grad():
        outs = [programs['decode'](image) for image in images]
        torch.cuda.synchronize()
    launches = read_launches(port)['cifhr_accumulate']
    check_program_calls(port, calls, launches, len(images), 'export (20a)')
    n_poses, differ = [], {}
    with torch.no_grad():
        eager_fields = [model(image) for image in images]
        for i, (out, fields) in enumerate(zip(outs, eager_fields)):
            eager = decode(*fields)
            ours = lane_poses(out[0])
            assert_pose_gate(list(ours), list(lane_poses(eager[0])))
            if not (torch.equal(out[1], eager[1])
                    and torch.equal(out[2], eager[2])):
                raise AssertionError(f'export (20a) image {i}: keep or '
                                     'order differ from the eager decode\'s')
            n_poses.append((len(ours), int(out[1].sum()),
                            int((out[0][0, :, :, 0] > 0).sum())))
            for name, a, b in zip(('poses', 'keep', 'order'), out, eager):
                if not torch.equal(a, b):
                    differ.setdefault(name, []).append(
                        (i, int((a != b).sum()), float(
                            (a.double() - b.double()).abs().max())))
    if not sum(n for n, _, _ in n_poses):
        raise AssertionError('export (20a): no pose has a visible joint')
    log(f'export (20a) decode program: (poses with a visible joint, kept, '
        f'visible joints) {n_poses} per image; every pose within the pose '
        'gate of the eager build_cifcaf_decoder\'s on the card, keep and '
        'order equal; '
        + ('bit-equal' if not differ else 'not bit-equal: (image, '
           f'elements, max abs difference) {differ}')
        + f'; its {len(calls)} CifHr calls launched the kernel, each map '
        f'bit-equal to the plain version [{card}]')

    times = {'program NN': [], 'program total': [], 'eager NN': [],
             'eager decode': []}
    reset_launches(port)
    with torch.no_grad():
        for _ in range(EXPORT_TIMED_PASSES):
            for image, fields in zip(images, eager_fields):
                times['program NN'].append(event_ms(
                    lambda: programs['fields'](image)))
                times['program total'].append(event_ms(
                    lambda: programs['decode'](image)))
        launches += read_launches(port)['cifhr_accumulate']
        for _ in range(EXPORT_TIMED_PASSES):
            for image, fields in zip(images, eager_fields):
                times['eager NN'].append(event_ms(lambda: model(image)))
                times['eager decode'].append(event_ms(
                    lambda: decode(*fields)))
        ms = {k: float(np.median(v)) for k, v in times.items()}
        log(f'export (20a) times, median of {EXPORT_TIMED_PASSES} passes '
            f'over {len(images)} images, CUDA events, ms/image: program NN '
            f'{ms["program NN"]:.3f}, program decode '
            f'{ms["program total"] - ms["program NN"]:.2f} (forward and '
            f'decode {ms["program total"]:.2f} less NN); eager NN '
            f'{ms["eager NN"]:.3f}, eager decode (standard tier) '
            f'{ms["eager decode"]:.2f} [{card}]')
        total = decode_profile(lambda: programs['decode'](images[0]))
        nn = decode_profile(lambda: programs['fields'](images[0]))
        eager = decode_profile(lambda: decode(*eager_fields[0]))
        with counted_rounds() as rounds:
            counted = decode(*eager_fields[0])
        eager_out = decode(*eager_fields[0])
        growth = grow_forms(decode, eager_fields[0], eager_out)
    if len(rounds) != len(FIXPOINTS) or not all(
            torch.equal(a, b) for a, b in zip(counted, eager_out)):
        raise AssertionError(f'export (20a): fixpoint rounds {rounds}, the '
                             'host loop\'s decode differs')
    log(f'export (20a) one exported decode (image 0): {total[0] - nn[0]} '
        f'device ops, {total[1] - nn[1]} stream syncs, device busy '
        f'{total[2] - nn[2]:.3f} ms (the forward-and-decode program\'s '
        f'{total[0]} ops, {total[1]} syncs less the fields program\'s '
        f'{nn[0]}, {nn[1]}); the eager standard tier {eager[0]} ops, '
        f'{eager[1]} syncs, busy {eager[2]:.3f} ms; while_loop rounds '
        f'{dict(zip(FIXPOINTS, rounds))} [{card}]')
    log(f'export (20a) the eager decode (image 0) with the growth\'s live '
        f'lanes gathered (`nonzero`, the eager form) against every lane '
        f'grown (the exported form): {GROW_PAIRS} alternating pairs, CUDA '
        'events, '
        f'median {growth["compact"]:.2f} / {growth["masked"]:.2f} ms, '
        f'gathering faster in {growth["wins"]} pairs, bit-equal [{card}]')
    return launches + phase_export_decode(
        port, decode, paths['decode-only'], walls['decode-only'],
        export_requests(model.head_metas, images,
                        [f[:2] for f in eager_fields]), card)


#: 20a's decode-only export, in a process of its own (in the smoke's own
#: process the same export took 85.0 s on the H100, 29.3 s in its own)
_DECODE_EXPORT = r'''
import sys, time
import torch
from openpifpaf_tpu_torch.models.shell import assign_strides
from openpifpaf_tpu_torch.ops.decode_cifcaf import build_cifcaf_decoder
from openpifpaf_tpu_torch.plugins.coco.constants import cocokp_head_metas


class DecodeProgram(torch.nn.Module):
    def __init__(self, decode):
        super().__init__()
        self.decode = decode

    def forward(self, cif, caf):
        return self.decode(cif, caf)


path, device = sys.argv[1:3]
stride, height, width = map(int, sys.argv[3:])
cif_meta, caf_meta = assign_strides(cocokp_head_metas(), stride)[:2]
decode = build_cifcaf_decoder(stride=cif_meta.stride,
                              skeleton=caf_meta.skeleton,
                              n_keypoints=len(cif_meta.keypoints))
fields = [torch.zeros((1, meta.n_fields, meta.n_components, height, width),
                      device=device) for meta in (cif_meta, caf_meta)]
start = time.perf_counter()
with torch.no_grad():
    program = torch.export.export(DecodeProgram(decode), tuple(fields))
traced = time.perf_counter() - start
torch.export.save(program, path)
print(f'traced in {traced:.1f} s')
'''


def export_requests(head_metas, images, posed):
    """{request: [(cif, caf) per image]} of 20a's decode-only program: the
    posed k16's fields of ``images`` (``posed``), EXPORT_PEOPLE drawn by
    the port's encoders, and the fields of the random k16 (seed 0, no
    posed heads: the main path's model) of ``images``."""
    from openpifpaf_tpu_torch.models import factory
    from openpifpaf_tpu_torch.plugins.coco.constants import cocokp_head_metas
    from torch_port_helpers import port_person, port_pose_fields

    device = images[0].device
    people = [port_person(fx * IMAGE_HW[1], 0.5 * IMAGE_HW[0],
                          fh * IMAGE_HW[0], np.random.RandomState(i))
              for i, (fx, fh) in enumerate(EXPORT_PEOPLE)]
    drawn = tuple(torch.from_numpy(f[None]).to(device) for f in
                  port_pose_fields(people, IMAGE_HW, *head_metas[:2]))
    model = factory.Factory().from_scratch(
        cocokp_head_metas(), generator=torch.Generator().manual_seed(0))
    model = model.to(device).eval()
    with torch.no_grad():
        sparse = [model(image)[:2] for image in images]
    del model
    shapes = {tuple(f.shape) for fields in (*posed, drawn, *sparse)
              for f in fields}
    if len(shapes) != 2:
        raise AssertionError(f'export (20a): request fields at {shapes}')
    return {'posed': posed, 'drawn': [drawn], 'sparse': sparse}


def run_decode_export(path, device, stride, field_hw):
    """``_DECODE_EXPORT`` of the CifCaf decode at ``stride`` and fields of
    ``field_hw`` on ``device``, into ``path``, in a process of its own;
    returns (wall seconds, its line of trace seconds)."""
    start = time.perf_counter()
    done = subprocess.run(
        [sys.executable, '-c', _DECODE_EXPORT, path, str(device),
         str(stride), *map(str, field_hw)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=600, check=False)
    wall = time.perf_counter() - start
    if done.returncode != 0:
        raise AssertionError(f'export (20a) decode-only failed '
                             f'({done.returncode}):\n{done.stderr[-4000:]}')
    return wall, done.stdout.strip()


def phase_export_decode(port, decode, path, export_wall, requests, card):
    """20a: the decode alone as a program (:func:`run_decode_export` into
    ``path``, (wall seconds, trace line) ``export_wall``), loaded here and
    run on each of ``requests``: bit-equal to the eager ``decode``, every
    CifHr call of it bit-equal to its plain version, the drawn request's
    EXPORT_PEOPLE kept whole; decode ms per image of the program and the
    eager decode, and the growth's forms on the sparse request. Returns
    the program's CifHr launches."""
    shape = tuple(requests['posed'][0][0].shape)
    program = torch.export.load(path).module()
    n_images = sum(len(fields) for fields in requests.values())

    reset_launches(port)
    with kept_launches(port.cifhr_cuda) as calls, torch.no_grad():
        outs = {name: [program(*f) for f in fields]
                for name, fields in requests.items()}
        torch.cuda.synchronize()
    launches = read_launches(port)['cifhr_accumulate']
    check_program_calls(port, calls, launches, n_images,
                        'export (20a) decode-only')
    with torch.no_grad():
        for name, fields in requests.items():
            for i, (f, out) in enumerate(zip(fields, outs[name])):
                if not all(torch.equal(a, b)
                           for a, b in zip(out, decode(*f))):
                    raise AssertionError(
                        f'export (20a) decode-only, {name} request image '
                        f'{i}: differs from the eager decode')
    poses, keep, _ = outs['drawn'][0]
    joints = (poses[0][keep[0]][:, :, 0] > 0).sum(dim=1).tolist()
    if joints != [poses.shape[2]] * len(EXPORT_PEOPLE):
        raise AssertionError(f'export (20a) decode-only, drawn request: '
                             f'kept poses of {joints} visible joints')
    kept = {name: [int(out[1].sum()) for out in o]
            for name, o in outs.items()}
    log(f'export (20a) decode-only program: exported on the card at CIF '
        f'fields {shape} in a process of its own (beside the CLI\'s two '
        'and (b)-(d)), '
        f'{export_wall[0]:.1f} s wall ({export_wall[1]}), '
        f'{os.path.getsize(path)} bytes, loaded here; kept poses per image '
        f'{kept}, the drawn people whole ({joints} visible joints); '
        f'bit-equal to the eager build_cifcaf_decoder on every request; '
        f'its {len(calls)} CifHr calls launched the kernel, each map '
        f'bit-equal to the plain version [{card}]')

    times = {}
    with torch.no_grad():
        reset_launches(port)
        for name, fields in requests.items():
            times[name, 'program'] = [
                event_ms(lambda: program(*f))
                for _ in range(EXPORT_TIMED_PASSES) for f in fields]
        launches += read_launches(port)['cifhr_accumulate']
        for name, fields in requests.items():
            times[name, 'eager'] = [
                event_ms(lambda: decode(*f))
                for _ in range(EXPORT_TIMED_PASSES) for f in fields]
        sparse = requests['sparse'][0]
        growth = grow_forms(decode, sparse, decode(*sparse))
    ms = {key: float(np.median(t)) for key, t in times.items()}
    log(f'export (20a) decode-only times, median of {EXPORT_TIMED_PASSES} '
        'passes, CUDA events, ms/image, program / eager: '
        + ', '.join(f'{name} {ms[name, "program"]:.2f} / '
                    f'{ms[name, "eager"]:.2f}' for name in requests)
        + f' [{card}]')
    log(f'export (20a) the eager decode of the sparse request (image 0) '
        f'with the live lanes gathered against every lane grown: '
        f'{GROW_PAIRS} alternating pairs, CUDA events, median '
        f'{growth["compact"]:.2f} / {growth["masked"]:.2f} ms, gathering '
        f'faster in {growth["wins"]} pairs, bit-equal [{card}]')
    return launches


def grow_forms(decode, fields, want):
    """The eager ``decode`` of ``fields`` with each form of the growth
    (``grow._grow_compact``, ``grow._grow_masked``) in GROW_PAIRS
    alternating pairs of CUDA-event times; both must give ``want``.
    Returns {form: median ms, 'wins': pairs the compact form won}."""
    from openpifpaf_tpu_torch.ops import grow

    live = grow._grow_live
    forms = {'compact': grow._grow_compact, 'masked': grow._grow_masked}
    times = {name: [] for name in forms}
    try:
        for name, form in forms.items():
            grow._grow_live = form
            if not all(torch.equal(a, b)
                       for a, b in zip(decode(*fields), want)):
                raise AssertionError(f'export (20a): the {name} growth '
                                     'changes the decode')
        for i in range(GROW_PAIRS):
            for name in list(forms)[::1 if i % 2 == 0 else -1]:
                grow._grow_live = forms[name]
                times[name].append(event_ms(lambda: decode(*fields)))
    finally:
        grow._grow_live = live
    out = {name: float(np.median(t)) for name, t in times.items()}
    out['wins'] = sum(c < m for c, m in zip(times['compact'],
                                            times['masked']))
    return out


def jpeglib_header():
    """The path of ``jpeglib.h`` in JPEG_INCLUDES, or None."""
    for directory in JPEG_INCLUDES:
        path = os.path.join(directory, 'jpeglib.h')
        if os.path.exists(path):
            return path
    return None


@contextlib.contextmanager
def loaders_taken():
    """Within: the loader (``'native'`` or ``'pil'``) that each
    ``Predictor.images`` call took is appended to the list this yields."""
    from openpifpaf_tpu_torch.predictor import Predictor

    images = Predictor.images
    taken = []

    def spied(self, file_names):
        yield from images(self, file_names)
        taken.append(self.last_image_loader)

    Predictor.images = spied
    try:
        yield taken
    finally:
        Predictor.images = images


def pose_table(predictions):
    """{file: [(n_kp, 3) [c, x, y] rows]} of ``read_predictions``."""
    return {name: [np.asarray(a['keypoints'], np.float64).reshape(-1, 3)
                   [:, [2, 0, 1]] for a in anns]
            for name, anns in predictions.items()}


def phase_native(port, ckpt, files, directory, card):
    """20b: the native loader probed and built; ``predict --long-edge``
    over the phase's JPEGs on each engine of NATIVE_ENGINES through the
    native loader and through PIL: which loader ``images`` took, the load
    ms per batch of each, NN and decode ms per image, CifHr and engine
    launches, every CifHr call bit-equal to its plain version, the native
    batch within NATIVE_PIL_MEAN_ATOL of PIL's and the poses of the two
    loaders compared. Returns {kernel: launches}."""
    import ctypes

    import PIL.Image
    from openpifpaf_tpu_torch import decoder, predict
    from openpifpaf_tpu_torch.datasets import ImageList
    from openpifpaf_tpu_torch.datasets.collate import \
        collate_images_anns_meta
    from openpifpaf_tpu_torch.io import native
    from openpifpaf_tpu_torch.predictor import Predictor
    from torch_port_helpers import assert_pose_gate, restored_statics

    header = jpeglib_header() or f'not found in {JPEG_INCLUDES}'
    try:
        start = time.perf_counter()
        lib = native.build()
        ctypes.CDLL(lib)
        built = native.native_available()
        log(f'native loader (20b): jpeglib.h {header}; built and loaded '
            f'{lib} in {time.perf_counter() - start:.2f} s [{card}]')
    except (RuntimeError, OSError) as e:
        built = False
        reason = (str(e).strip().splitlines() or [repr(e)])[0]
        log(f'native loader (20b): jpeglib.h {header}; the loader does not '
            f'build or load on this machine ({reason}): predict takes the '
            f'PIL path here, as JAX does without libjpeg [{card}]')

    paths = [f for request in files for f in request]
    if built:
        loader = native.NativeImageLoader(long_edge=NATIVE_LONG_EDGE)
        ours, _ = loader.load_batch(paths)
        diffs = []
        for image, path in zip(ours, paths):
            with open(path, 'rb') as f:
                pil = PIL.Image.open(f).convert('RGB')
            ref, _, _ = pil_preprocess(NATIVE_LONG_EDGE)(
                pil, [], {'dataset_index': 0})
            sh, sw = ref.shape[:2]
            diffs.append(float(np.abs(image[:sh, :sw] - ref[:sh, :sw])
                               .mean()))
        if not max(diffs) < NATIVE_PIL_MEAN_ATOL:
            raise AssertionError(f'native loader (20b): mean abs difference '
                                 f'from PIL {diffs}')
        load_ms = {'native': [], 'pil': []}
        for _ in range(3):
            for request in files:
                start = time.perf_counter()
                loader.load_batch_uint8(request)
                load_ms['native'].append((time.perf_counter() - start) * 1e3)
                start = time.perf_counter()
                data = ImageList(request,
                                 preprocess=pil_preprocess(NATIVE_LONG_EDGE))
                collate_images_anns_meta([data[i] for i in range(len(data))])
                load_ms['pil'].append((time.perf_counter() - start) * 1e3)
        log(f'native loader (20b): its normalised batch within '
            f'{max(diffs):.4f} (mean abs) of the PIL path\'s (gate '
            f'{NATIVE_PIL_MEAN_ATOL}); load ms per batch (host clock, '
            f'median of 3 passes over the {len(files)} requests): native '
            f'{np.median(load_ms["native"]):.2f}, PIL '
            f'{np.median(load_ms["pil"]):.2f} [{card}]')

    launches = {'cifhr_accumulate': 0}
    for engine, kernel in NATIVE_ENGINES.items():
        predictions = {}
        for way in ('native', 'pil') if built else ('pil',):
            label = f'native loader (20b) {engine} {way}'
            out = os.path.join(directory, f'native-{engine}-{way}')
            os.makedirs(out)
            argv = ['--checkpoint', ckpt, '--backbone-engine', engine,
                    '--long-edge', str(NATIVE_LONG_EDGE),
                    *REF_DECODER_FLAGS, '--json-output', out]
            native_io = Predictor.native_io
            Predictor.native_io = way == 'native'
            reset_launches(port)
            try:
                with loaders_taken() as taken, recorded_runs([]) as records, \
                        kept_cifhr_calls(port.cifhr_cuda) as calls, \
                        restored_statics(*decoder.DECODERS):
                    predict.main([*files[0], *files[1], *files[2], *argv])
                    predict.main([*files[3], '--batch-size', '2', *argv])
            finally:
                Predictor.native_io = native_io
            counts = read_launches(port)
            if taken != [way] * 2:
                raise AssertionError(f'{label}: images took {taken}')
            check_records(records, label, ((17, 5), (19, 8)), card,
                          at_field_hw=False)
            want = FORWARD_LAUNCHES * len(records)
            if counts[kernel] != want or counts['cifhr_accumulate'] != \
                    len(calls):
                raise AssertionError(f'{label}: launches {counts}, want '
                                     f'{want} {kernel}, {len(calls)} CifHr')
            check_kept_calls(port, calls, label)
            for name in (kernel, 'cifhr_accumulate'):
                launches[name] = launches.get(name, 0) + counts[name]
            predictions[way] = pose_table(read_predictions(out))
            warm = records[1:3]
            log(f'{label}: images took the {taken[0]} loader; NN '
                f'{np.mean([r["nn_ms"] for r in warm]):.3f} ms/image, '
                f'decode {np.mean([r["decode_ms"] for r in warm]):.2f} '
                f'ms/image (the 2 warm batch-1 requests); fields '
                f'{records[0]["hw"]}; poses per image '
                f'{[len(p) for p in predictions[way].values()]} [{card}]')
        if built:
            try:
                for name in predictions['pil']:
                    assert_pose_gate(predictions['native'][name],
                                     predictions['pil'][name])
                line = 'pass the pose gate'
            except AssertionError as e:
                reason = (str(e).strip().splitlines() or ['locations'])[0]
                line = (f'differ beyond the pose gate ({reason}): the '
                        'native loader\'s bilinear resize gives other '
                        'pixels than PIL\'s antialiased one')
            log(f'native loader (20b) {engine}: the native path\'s poses '
                f'against the PIL path\'s {line} [{card}]')
    return launches


_CACHE_BUILD = r'''
import argparse, json, os, sys, time
sys.path.insert(0, sys.argv[1])
from openpifpaf_tpu_torch import _nvcc, logger
from openpifpaf_tpu_torch.io import native
parser = argparse.ArgumentParser()
logger.cli(parser)
args = parser.parse_args(sys.argv[2:4])
logger.configure(args)
out = {}
for source in sys.argv[4:]:
    start = time.perf_counter()
    path = native.build() if source == 'pifpaf_io.cpp' \
        else _nvcc.build(source)
    out[source] = [time.perf_counter() - start, path,
                   os.path.getmtime(path)]
print(json.dumps(out))
'''


def phase_build_cache(directory, card, native_built):
    """20c: CACHE_SOURCES (and the native loader where it builds) built
    with ``--xla-compilation-cache`` of a fresh directory in one process,
    then in a second: the first builds, the second only loads."""
    cache = os.path.join(directory, 'kernel-cache')
    sources = list(CACHE_SOURCES) + (['pifpaf_io.cpp'] if native_built
                                     else [])
    runs = []
    for _ in range(2):
        done = subprocess.run(
            [sys.executable, '-c', _CACHE_BUILD, ROOT,
             '--xla-compilation-cache', cache, *sources], cwd=directory,
            capture_output=True, text=True, timeout=600, check=False)
        if done.returncode != 0:
            raise AssertionError(f'build cache (20c): {done.stderr[-3000:]}')
        runs.append(json.loads(done.stdout.strip().splitlines()[-1]))
    for source in sources:
        (t1, p1, m1), (t2, p2, m2) = runs[0][source], runs[1][source]
        if os.path.dirname(p1) != cache or p1 != p2 or m1 != m2:
            raise AssertionError(f'build cache (20c) {source}: {runs}')
        log(f'build cache (20c) {source}: built into a fresh '
            f'--xla-compilation-cache in {t1:.2f} s, loaded from it by a '
            f'second process in {t2 * 1e3:.2f} ms (not rebuilt) [{card}]')


def phase_profile_train(directory, card):
    """20c: PROFILE_STEPS steps of phase 11's k16 training (batch 8, 385 px,
    float32) with ``--profile``: one Chrome trace per step, each trace's
    device ops (a trace with none is reported as such). Returns the
    training log's path."""
    from openpifpaf_tpu_torch import train
    from torch_port_helpers import write_synthetic_coco

    data = write_synthetic_coco(
        os.path.join(directory, 'coco'), n_images=TRAIN_BATCH * PROFILE_STEPS,
        image_hw=TRAIN_IMAGE_HW, seed=TRAIN_SEED)
    out = os.path.join(directory, 'profiled', 'model')
    os.makedirs(os.path.dirname(out))
    prefix = os.path.join(directory, 'profiled', 'step')
    start = time.perf_counter()
    trainer = train.main(train_flags(
        data, out, '--train-batches', str(PROFILE_STEPS), '--val-batches',
        '1', '--profile', prefix))
    wall = time.perf_counter() - start
    traces = trainer.train_step.traces
    if [os.path.basename(p) for p, _ in traces] != \
            [f'step.{i}.json' for i in range(1, PROFILE_STEPS + 1)] \
            or not all(os.path.getsize(p) for p, _ in traces):
        raise AssertionError(f'train --profile (20c): traces {traces}')
    empty = [p for p, n in traces if not n]
    for path in empty:
        log(f'train --profile (20c): {os.path.basename(path)} recorded no '
            'device op: the profiler missed the card\'s launches (not read '
            'as zero)')
    if len(empty) == len(traces):
        raise AssertionError('train --profile (20c): no trace recorded a '
                             'device op')
    log(f'train --profile (20c): {PROFILE_STEPS} steps, one trace each: '
        + ', '.join(f'{os.path.basename(p)} {n} device ops '
                    f'{os.path.getsize(p)} bytes' for p, n in traces)
        + f'; whole run {wall:.1f} s [{card}]')
    return out + '.log'


def phase_logs(log_path, card):
    """20d: ``logs --print-last`` of (c)'s training log: its last train
    row; nothing is drawn (matplotlib is imported only to draw)."""
    import io
    from openpifpaf_tpu_torch import logs

    buffer = io.StringIO()
    with contextlib.redirect_stdout(buffer):
        logs.main([log_path, '--print-last'])
    lines = buffer.getvalue().strip().splitlines()
    if len(lines) != 1 or not lines[0].startswith(f'{log_path}: ') \
            or "'type': 'train'" not in lines[0]:
        raise AssertionError(f'logs --print-last (20d): {lines}')
    log(f'logs --print-last (20d): {lines[0][len(log_path) + 2:]}; drawn '
        f'nothing (matplotlib {"installed" if has_matplotlib() else "absent"}'
        f') [{card}]')


def phase_deploy(port, device, card, runner_dir):
    """Phase 20: (a)-(d); (a)'s two decode programs are copied into
    ``runner_dir`` for phase 22. Returns {kernel: launches} of (a) and
    (b)."""
    import shutil
    import tempfile
    from openpifpaf_tpu_torch.io import native

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as directory, \
            ThreadPoolExecutor(len(EXPORTS)) as pool:
        ckpt = posed_k16_checkpoint(directory)
        files = write_requests(directory)
        # 20a's exports take a minute: (b)-(d) run beside them
        exports = start_exports(pool, ckpt, directory, device)
        launches = phase_native(port, ckpt, files, directory, card)
        log_path = phase_profile_train(directory, card)
        phase_build_cache(directory, card, native.native_available())
        phase_logs(log_path, card)
        launches['cifhr_accumulate'] = launches.get(
            'cifhr_accumulate', 0) + phase_export(
                port, ckpt, phase_images(files, device), directory, device,
                card, exports)
        for name in ('decode', 'decode-only'):
            shutil.copy(os.path.join(directory, f'k16-{name}.pt2'),
                        os.path.join(runner_dir, f'k16-{name}.pt2'))
    log(f'phase 20: launches {launches}; {time.perf_counter() - t0:.1f} s '
        f'[{card}]')
    return launches


#: phase 21: the requests of the pipelined serving loop (481x641 JPEGs)
#: and the engines it runs on, with the backbone kernel each launches
PIPE_REQUESTS = 8
PIPE_ENGINES = {'pallas': 'shuffle_block', 'dwpallas': 'depthwise_conv'}
PIPE_BATCHES = (1, 2)
#: the fused block's kernel, as the profiler names it
BLOCK_SYMBOL = BACKBONE_SYMBOLS['shuffle_block']
#: 21b: the data-parallel train run at world size 1 against the plain
#: single-process run on the same batches (float32, TF32 off): the first
#: step's loss and components, from the same parameters, within
#: DDP_LOSS_RTOL of the loss; the later steps' within DDP_LATER_RTOL. The
#: cross-rank BatchNorm sums in another order than ``F.batch_norm``, and
#: the gradients of the BatchNorm biases that the next BatchNorm cancels
#: are rounding noise of the loss's large gradients (1.5x apart between
#: the two, 1.2% of the whole gradient, at 97 px on the CPU), so
#: each update parts the runs by about 20x more (on the H100: 2.7e-8,
#: 5.0e-5, 9.65e-4 of the loss at steps 1-3); the CPU tests hold two gloo
#: ranks within 1e-5 at every step in float64
DDP_STEPS = 3
DDP_LOSS_RTOL = 1e-5
DDP_LATER_RTOL = 1e-2


def write_pipe_requests(directory):
    """PIPE_REQUESTS random JPEGs of IMAGE_HW (seed 21); their paths."""
    import PIL.Image

    rng = np.random.RandomState(21)
    files = []
    for i in range(PIPE_REQUESTS):
        path = os.path.join(directory, f'pipe{i}.jpg')
        PIL.Image.fromarray(rng.randint(0, 256, IMAGE_HW + (3,),
                                        dtype=np.uint8)).save(path,
                                                              quality=95)
        files.append(path)
    return files


@contextlib.contextmanager
def cifhr_streams(cifhr_cuda):
    """Within: the current CUDA stream of each ``cifhr_cuda.accumulate``
    call (the stream its kernel launches on) is appended to the list this
    yields."""
    accumulate = cifhr_cuda.accumulate
    streams = []

    def recorded(x, *args, **kw):
        streams.append(torch.cuda.current_stream(x.device))
        return accumulate(x, *args, **kw)

    cifhr_cuda.accumulate = recorded
    try:
        yield streams
    finally:
        cifhr_cuda.accumulate = accumulate


def annotation_rows(annotations):
    """(score, data, joint scales) of each annotation, for equality."""
    return [(a.score, a.data.tobytes(), a.joint_scales.tobytes())
            for a in annotations]


def pipe_predict(port, files, argv, label):
    """``predict.main`` over ``files`` with ``argv`` in-process, the launch
    counts set to 0 just before and read just after; returns (the
    annotations that CifCaf's decodes gave, in order, the launches, the
    wall s, the CifHr calls' cells and streams, the Predictor's NN and
    decoder s in total)."""
    from openpifpaf_tpu_torch import decoder, predict
    from openpifpaf_tpu_torch.predictor import Predictor
    from torch_port_helpers import restored_statics

    totals = {}
    init = Predictor.__init__

    def kept_predictor(self, *args, **kwargs):
        init(self, *args, **kwargs)
        totals['predictor'] = self

    reset_launches(port)
    Predictor.__init__ = kept_predictor
    try:
        with decoded_annotations() as decoded, \
                kept_cifhr_calls(port.cifhr_cuda) as calls, \
                cifhr_streams(port.cifhr_cuda) as streams, \
                restored_statics(*decoder.DECODERS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            predict.main([*files, *argv])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        Predictor.__init__ = init
    counts = read_launches(port)
    if counts['cifhr_accumulate'] != len(calls) or not calls:
        raise AssertionError(f'{label}: {counts["cifhr_accumulate"]} CifHr '
                             f'launches, {len(calls)} calls')
    predictor = totals['predictor']
    return (decoded, counts, wall, calls, streams,
            (predictor.total_nn_time, predictor.total_decoder_time))


def kernel_spans(prof):
    """The device events of a ``torch.profiler`` session as (name, stream,
    start ns, end ns), and the host spans of its ``decode`` ranges as
    (start ns, end ns), from the profiler's raw events (a Chrome trace of
    a pipelined run holds ~70000 kernels)."""
    from torch.autograd import DeviceType

    kernels, decodes = [], []
    for e in prof.profiler.kineto_results.events():
        span = (e.start_ns(), e.start_ns() + e.duration_ns())
        if e.is_user_annotation():
            if e.device_type() == DeviceType.CPU and e.name() == 'decode':
                decodes.append(span)
        elif e.device_type() == DeviceType.CUDA:
            kernels.append((e.name(), e.device_resource_id(), *span))
    return kernels, decodes


def pipe_overlap(port, files, argv, label, card):
    """One pipelined ``predict.main`` over ``files`` (:func:`pipe_predict`)
    in a ``torch.profiler`` session, each materialised decode a
    ``decode`` range: the fused block's launches of batch i+1 that ran on
    the card while batch i's decode ran on its side stream, CifHr's
    stream against the fused block's, and the device's busy share of the
    loop. Returns :func:`pipe_predict`'s results."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from openpifpaf_tpu_torch.predictor import Predictor

    materialize = Predictor._materialize_batch

    def ranged(self, staged):
        with record_function('decode'):
            out = list(materialize(self, staged))
        yield from out

    Predictor._materialize_batch = ranged
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            results = pipe_predict(port, files, argv, label)
    finally:
        Predictor._materialize_batch = materialize
    kernels, decodes = kernel_spans(prof)
    blocks = [k for k in kernels if BLOCK_SYMBOL in k[0]]
    cifhr = [k for k in kernels if 'cifhr' in k[0]]
    if not blocks or not cifhr or len(decodes) != len(files):
        raise AssertionError(f'{label}: trace of {len(blocks)} fused-block '
                             f'and {len(cifhr)} CifHr kernels, '
                             f'{len(decodes)} decode ranges')
    block_streams = {k[1] for k in blocks}
    cifhr_streams_seen = {k[1] for k in cifhr}
    if block_streams & cifhr_streams_seen:
        raise AssertionError(f'{label}: CifHr on streams '
                             f'{cifhr_streams_seen}, the forward on '
                             f'{block_streams}')
    overlapped = [k for k in blocks
                  if any(k[2] < d1 and k[3] > d0 for d0, d1 in decodes)]
    overlap_ns = sum(min(k[3], d1) - max(k[2], d0) for k in blocks
                     for d0, d1 in decodes if k[2] < d1 and k[3] > d0)
    span = max(k[3] for k in kernels) - min(k[2] for k in kernels)
    busy = sum(k[3] - k[2] for k in kernels)
    log(f'{label} traced: {len(overlapped)} of {len(blocks)} fused-block '
        f'launches ran while a decode was materialising on the side stream '
        f'({overlap_ns / 1e6:.3f} ms of device time under the decodes); '
        f'CifHr on stream(s) {sorted(cifhr_streams_seen)}, the forward on '
        f'{sorted(block_streams)}; device events busy {busy / 1e6:.2f} ms '
        f'of {span / 1e6:.2f} ms ({busy / span:.3f} of the span; '
        f'{len(kernels)} device events) [{card}]')
    return results


def pipe_serve(port, ckpt, files, directory, card):
    """21a: the posed k16 through ``predict.main`` on each engine of
    PIPE_ENGINES at each batch size of PIPE_BATCHES, pipelined (default)
    and with ``--no-pipeline-decode``: bit-equal annotations, each CifHr
    call a counted launch on the decode's side stream, bit-equal to its
    plain version, the engine's kernel FORWARD_LAUNCHES times per forward;
    wall ms per image of both loops. Returns {kernel: launches}."""
    from openpifpaf_tpu_torch.decoder.cifcaf import side_stream

    side = side_stream(torch.device('cuda:0'))
    default = torch.cuda.default_stream(torch.device('cuda:0'))
    launches = {}
    for engine, kernel in PIPE_ENGINES.items():
        for batch in PIPE_BATCHES:
            argv = ['--checkpoint', ckpt, '--backbone-engine', engine,
                    '--batch-size', str(batch), *REF_DECODER_FLAGS]
            label = f'pipeline (21a) {engine} batch {batch}'
            runs = {}
            for name, extra in (('strict', ['--no-pipeline-decode']),
                                ('pipelined', [])):
                runs[name] = pipe_predict(port, files, argv + extra, label)
            forwards = len(files) // batch
            for name, (decoded, counts, wall, calls, streams, totals) in \
                    runs.items():
                for key in ('depthwise_conv', 'shuffle_block',
                            'shuffle_branch2'):
                    want = FORWARD_LAUNCHES * forwards if key == kernel \
                        else 0
                    if counts[key] != want:
                        raise AssertionError(
                            f'{label} {name}: {counts[key]} {key} launches '
                            f'in {forwards} forwards, want {want}')
                if any(st != side or st == default for st in streams):
                    raise AssertionError(f'{label} {name}: CifHr launched '
                                         'off the side stream')
                check_kept_calls(port, calls, f'{label} {name}')
                for key, count in counts.items():
                    launches[key] = launches.get(key, 0) + count
            rows = {name: annotation_rows(r[0]) for name, r in runs.items()}
            if rows['pipelined'] != rows['strict'] or not rows['strict']:
                raise AssertionError(f'{label}: pipelined annotations differ '
                                     f'from the strict loop\'s '
                                     f'({len(rows["pipelined"])} vs '
                                     f'{len(rows["strict"])})')
            log(f'{label}: {len(rows["strict"])} annotations bit-equal '
                'between the loops; every CifHr call launched on the side '
                'stream; wall '
                + ', '.join(f'{name} {r[2] / len(files) * 1e3:.2f}'
                            for name, r in runs.items())
                + ' ms/image (the process\'s whole predict.main, first '
                'request included); NN '
                + ', '.join(f'{name} {r[5][0] / len(files) * 1e3:.3f}'
                            for name, r in runs.items())
                + ' ms/image (strict: host clock, pipelined: CUDA events); '
                'decode '
                + ', '.join(f'{name} {r[5][1] / len(files) * 1e3:.2f}'
                            for name, r in runs.items())
                + f' ms/image [{card}]')
            if batch == PIPE_BATCHES[0] and engine == next(iter(
                    PIPE_ENGINES)):
                reference = rows['strict']
    return launches, reference


def pipe_eager(ckpt, files, reference, card):
    """``reference`` (the loops' annotations of PIPE_ENGINES' first engine
    at batch 1) against ``CifCaf.batch_decode`` called directly, on the
    card, on the fields of each image alone."""
    from openpifpaf_tpu_torch import datasets, decoder, predict
    from openpifpaf_tpu_torch.datasets.collate import \
        collate_images_anns_meta
    from openpifpaf_tpu_torch.predictor import Predictor
    from torch_port_helpers import restored_statics

    # the flags stay set through the decode (the crowd tier reads its
    # pose budget then)
    with restored_statics(*decoder.DECODERS):
        predict.cli(['request.jpg', *REF_DECODER_FLAGS])
        predictor = Predictor(checkpoint=ckpt,
                              backbone_engine=next(iter(PIPE_ENGINES)))
        predictor.pipeline_decode = False
        cifcaf = predictor.processor.decoders[0]
        images = datasets.ImageList(files, preprocess=predictor.preprocess)
        eager = []
        for i in range(len(files)):
            image_batch, _, _ = collate_images_anns_meta([images[i]])
            eager.extend(cifcaf.batch_decode(
                predictor.fields_batch(image_batch))[0])
    if annotation_rows(eager) != reference:
        raise AssertionError('pipeline (21a): the loops\' annotations '
                             'differ from the eager decode\'s')
    log(f'pipeline (21a): the loops\' {len(eager)} annotations equal those '
        'of CifCaf.batch_decode called directly on each image\'s fields '
        f'[{card}]')


def pipe_eval(ckpt, directory, card):
    """21a: ``eval_cli.main`` in-process with the posed k16 over phase
    12's synthetic COCO set (EVAL_IMAGES images, seed 0) at long edge
    EVAL_LONG_EDGE, strict (eval's default) and ``--pipeline-decode``:
    the same stats and predictions. Returns the CifHr launches."""
    from openpifpaf_tpu_torch import datasets, decoder, eval_cli
    from openpifpaf_tpu_torch.ops import cifhr_cuda
    from torch_port_helpers import restored_statics, write_synthetic_coco

    ann_file, image_dir = write_synthetic_coco(
        os.path.join(directory, 'pipe-coco'), n_images=EVAL_IMAGES,
        image_hw=TRAIN_IMAGE_HW, seed=0)
    results = {}
    launches = 0
    for name, extra in (('strict', []), ('pipelined', ['--pipeline-decode'])):
        out = os.path.join(directory, f'pipe-eval-{name}')
        before = cifhr_cuda.LAUNCHES
        with restored_statics(*decoder.DECODERS,
                              *datasets.datamodules().values(),
                              eval_cli.Evaluator):
            eval_cli.main(['--dataset', 'cocokp', '--checkpoint', ckpt,
                           '--cocokp-val-annotations', ann_file,
                           '--cocokp-val-image-dir', image_dir,
                           '--coco-eval-long-edge', str(EVAL_LONG_EDGE),
                           '--eval-loader-warmup', '0', '--write-predictions',
                           '--output', out, *REF_DECODER_FLAGS, *extra])
        launches += cifhr_cuda.LAUNCHES - before
        with open(out + '.stats.json') as f:
            stats = json.load(f)
        with open(out + '.pred.json') as f:
            results[name] = (stats, json.load(f))
    (strict, strict_pred), (piped, piped_pred) = results.values()
    if not (strict['stats'] == piped['stats'] and strict_pred == piped_pred
            and strict['n_images'] == piped['n_images'] == EVAL_IMAGES
            and strict_pred):
        raise AssertionError(f'pipeline (21a) eval: stats {strict["stats"]} '
                             f'strict, {piped["stats"]} pipelined')
    log(f'pipeline (21a) eval --pipeline-decode: the strict loop\'s stats '
        f'{[round(v, 4) for v in strict["stats"]]} and '
        f'{len(strict_pred)} predictions over {EVAL_IMAGES} images; per '
        'image nn / decoder ms: strict '
        f'{strict["nn_time"] / EVAL_IMAGES * 1e3:.3f} / '
        f'{strict["decoder_time"] / EVAL_IMAGES * 1e3:.2f}, pipelined '
        f'{piped["nn_time"] / EVAL_IMAGES * 1e3:.3f} / '
        f'{piped["decoder_time"] / EVAL_IMAGES * 1e3:.2f} [{card}]')
    return launches


def phase_pipe_serve(port, device, card):
    """21a: :func:`pipe_serve`, the eager decode (:func:`pipe_eager`),
    ``--decode-device 0`` traced for the overlap (:func:`pipe_overlap`)
    and the eval (:func:`pipe_eval`). Returns {kernel: launches}."""
    import tempfile
    from openpifpaf_tpu_torch.decoder.cifcaf import side_stream

    with tempfile.TemporaryDirectory() as directory:
        ckpt = posed_k16_checkpoint(directory)
        files = write_pipe_requests(directory)
        launches, reference = pipe_serve(port, ckpt, files, directory, card)
        pipe_eager(ckpt, files, reference, card)
        engine = next(iter(PIPE_ENGINES))
        argv = ['--checkpoint', ckpt, '--backbone-engine', engine,
                *REF_DECODER_FLAGS]
        decoded, counts, _, calls, streams, _ = pipe_overlap(
            port, files, [*argv, '--decode-device', '0'],
            f'pipeline (21a) {engine} batch 1 --decode-device 0', card)
        if annotation_rows(decoded) != reference:
            raise AssertionError('pipeline (21a) --decode-device 0: '
                                 'annotations differ')
        side = side_stream(torch.device('cuda:0'))
        if any(st != side for st in streams):
            raise AssertionError('pipeline (21a) --decode-device 0: CifHr '
                                 'launched off the side stream')
        check_kept_calls(port, calls, 'pipeline (21a) --decode-device 0')
        for key, count in counts.items():
            launches[key] += count
        log('pipeline (21a) --decode-device 0: the same annotations, the '
            'decode on cuda:0\'s side stream (this machine has one card: '
            f'no other decode device is claimed) [{card}]')
        launches['cifhr_accumulate'] += pipe_eval(ckpt, directory, card)
    return launches


def phase_ddp(port, device, card):
    """21b: ``train.main --n-devices 1`` for DDP_STEPS steps (NCCL at
    world size 1, the cross-rank BatchNorm in the graph) against the
    plain single-process ``train.main`` on the same batches (np.random
    seeded as the rank's): each step's loss and components within
    DDP_LOSS_RTOL of the loss (TF32 off); ``predict --n-devices 2``
    raises on one card."""
    import tempfile
    from openpifpaf_tpu_torch import parallel, predict, train
    from openpifpaf_tpu_torch.models.basenetworks import BatchNorm
    from openpifpaf_tpu_torch.training.trainer import Trainer
    from torch_port_helpers import write_synthetic_coco

    step = Trainer.train_step
    seen = {}

    def recorded(self, *args, **kwargs):
        loss, heads = step(self, *args, **kwargs)
        seen.setdefault('steps', []).append(
            [float(loss)] + [float(h) for h in heads])
        seen['cross_rank'] = any(
            isinstance(m, BatchNorm) and m.process_group is not None
            for m in self.model.modules())
        seen['ddp'] = isinstance(self._step_module,
                                 torch.nn.parallel.DistributedDataParallel)
        return loss, heads

    runs = {}
    with tempfile.TemporaryDirectory() as directory:
        data = write_synthetic_coco(
            os.path.join(directory, 'coco'), n_images=TRAIN_BATCH * DDP_STEPS,
            image_hw=TRAIN_IMAGE_HW, seed=0)
        Trainer.train_step = recorded
        try:
            for name, extra in (('plain', []), ('ddp', ['--n-devices', '1'])):
                seen.clear()
                out = os.path.join(directory, name, 'model')
                os.makedirs(os.path.dirname(out))
                argv = train_flags(data, out, *extra)
                argv[argv.index('--train-batches') + 1] = str(DDP_STEPS)
                np.random.seed(parallel.rank_seed(TRAIN_SEED, 0))
                t0 = time.perf_counter()
                with no_tf32():
                    train.main(argv)
                runs[name] = (dict(seen), time.perf_counter() - t0)
        finally:
            Trainer.train_step = step
    (plain, plain_s), (ddp, ddp_s) = runs['plain'], runs['ddp']
    if not (ddp['ddp'] and ddp['cross_rank'] and not plain['ddp']
            and not plain['cross_rank']
            and len(ddp['steps']) == len(plain['steps']) == DDP_STEPS):
        raise AssertionError(f'ddp (21b): runs {runs}')
    errs = [max(abs(a - b) for a, b in zip(d, p)) / abs(p[0])
            for d, p in zip(ddp['steps'], plain['steps'])]
    if not (errs[0] <= DDP_LOSS_RTOL
            and max(errs[1:]) <= DDP_LATER_RTOL):
        raise AssertionError(f'ddp (21b): losses {ddp["steps"]} under DDP, '
                             f'{plain["steps"]} plain: {errs} of the loss')
    log(f'ddp (21b): train --n-devices 1 (DDP, NCCL, world size 1, the '
        f'cross-rank BatchNorm) for {DDP_STEPS} steps: losses '
        f'{[d[0] for d in ddp["steps"]]} against the plain single-process '
        f'run\'s {[p[0] for p in plain["steps"]]}: each step\'s loss and '
        f'components within {[float(f"{e:.3g}") for e in errs]} of the '
        f'loss (gates {DDP_LOSS_RTOL} for the first step, {DDP_LATER_RTOL} '
        f'after; TF32 off); runs {plain_s:.1f} s plain, {ddp_s:.1f} s DDP; '
        'world size 2 runs only in the CPU tests (gloo): this machine has '
        f'one card [{card}]')
    from openpifpaf_tpu_torch import decoder
    from torch_port_helpers import restored_statics
    try:
        with restored_statics(*decoder.DECODERS):
            predict.main(['request.jpg', '--n-devices', '2'])
    except ValueError as e:
        log(f'ddp (21b): predict --n-devices 2 on one card raises: {e}')
    else:
        raise AssertionError('predict --n-devices 2 ran on one card')


def phase_pipeline(port, device, card):
    """Phase 21: (a) the pipelined serving loop, (b) DDP on the card.
    Returns {kernel: launches} of (a)."""
    t0 = time.perf_counter()
    launches = phase_pipe_serve(port, device, card)
    phase_ddp(port, device, card)
    log(f'phase 21: launches {launches}; {time.perf_counter() - t0:.1f} s '
        f'[{card}]')
    return launches


#: phase 22: the package's export may take this long (AOTInductor's
#: compile of the whole program)
PACKAGE_TIMEOUT = 900
#: phase 22's compiles run beside phases 12-21 at a lower priority, so
#: that they take idle cores rather than the host time those phases time
NICE = ('nice', '-n', '10')
#: the runner's default --instance-threshold (JAX's runner's)
RUNNER_INSTANCE_THRESHOLD = 0.15
#: the runner's JSON against the Python-loaded package: its printed
#: precision (%.4f scores, %.2f keypoints, %.3f confidences)
RUNNER_ATOL = {'score': 1e-4, 'xy': 0.01, 'v': 1e-3}
#: the pose gate (counts and visibility equal, xy within 1e-3 px,
#: confidences within 2e-3), lane by lane
LANE_XY_ATOL = 1e-3
LANE_V_ATOL = 2e-3
#: the video runner's clip
RUNNER_VIDEO_FRAMES = 3
#: the fields package against the eager module graph, of each head's
#: largest value: Inductor computes the NN in another order (BatchNorms
#: folded into its kernels, its own conv layouts), 8.6e-5-9.8e-5 on the
#: H100 with TF32 off or on, where 20a's interpreted program is bit-equal
PACKAGE_FIELDS_RTOL = 1e-3


def timed(fn, *args, **kwargs):
    """(fn's result, its wall seconds)."""
    start = time.perf_counter()
    return fn(*args, **kwargs), time.perf_counter() - start


def build_runner():
    """``python -m openpifpaf_tpu_torch.cpp_runner`` in a process of its
    own under NICE: (what it built, as a namespace, its wall seconds)."""
    start = time.perf_counter()
    done = subprocess.run(
        [*NICE, sys.executable, '-m', 'openpifpaf_tpu_torch.cpp_runner'],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=PACKAGE_TIMEOUT, check=False)
    if done.returncode != 0:
        raise AssertionError(f'runner build failed ({done.returncode}):\n'
                             f'{done.stdout[-2000:]}{done.stderr[-6000:]}')
    made = json.loads(done.stdout.strip().splitlines()[-1])
    return types.SimpleNamespace(**made), time.perf_counter() - start


def start_runner(pool, directory):
    """Phase 22's long steps, submitted to ``pool``: the exports of phase
    19's posed k16 (written into ``directory``) as AOTInductor packages of
    (poses, keep) and of the fields, each in a process of its own, and the
    build of the C++ runner and its operator library from this checkout's
    sources. Returns {'directory', 'ckpt', 'package', 'fields', 'pt2' and
    'program' (where phase 20 copies its forward-and-decode and its
    decode-only programs), 'export', 'export_fields', 'build'
    (futures)}."""
    ckpt = posed_k16_checkpoint(directory)
    paths = {name: os.path.join(directory, f'k16-{name}.pt2')
             for name in ('package', 'fields-package', 'decode',
                          'decode-only')}
    return {
        'directory': directory, 'ckpt': ckpt, 'package': paths['package'],
        'fields': paths['fields-package'], 'pt2': paths['decode'],
        'program': paths['decode-only'],
        'export': pool.submit(run_export, ckpt, paths['package'], '--format',
                              'savedmodel', '--with-decoder',
                              timeout=PACKAGE_TIMEOUT, nice=NICE),
        'export_fields': pool.submit(run_export, ckpt,
                                     paths['fields-package'], '--format',
                                     'savedmodel', timeout=PACKAGE_TIMEOUT,
                                     nice=NICE),
        'build': pool.submit(build_runner)}


def check_lanes(out, ref, label):
    """``out`` (poses, keep, ...) against ``ref`` lane by lane: keep equal,
    and each lane's pose within the pose gate of the same lane (so the
    kept poses are the same and in the same order); then the pose gate on
    the poses with a visible joint. Returns (bit-equal, largest xy and
    confidence differences)."""
    from torch_port_helpers import assert_pose_gate

    if not torch.equal(out[1].cpu(), ref[1].cpu()):
        raise AssertionError(f'{label}: keep differs')
    ours, theirs = out[0][0].double().cpu(), ref[0][0].double().cpu()
    visible = ours[..., 0] > 0
    if not torch.equal(visible, theirs[..., 0] > 0):
        raise AssertionError(f'{label}: visibility differs')
    xy = float((ours[..., 1:3] - theirs[..., 1:3])[visible].abs().max()) \
        if visible.any() else 0.0
    v = float((ours[..., 0] - theirs[..., 0]).abs().max())
    if not (xy <= LANE_XY_ATOL and v <= LANE_V_ATOL):
        raise AssertionError(f'{label}: xy {xy}, confidence {v} beyond the '
                             'pose gate')
    assert_pose_gate(list(lane_poses(out[0])), list(lane_poses(ref[0])))
    return torch.equal(out[0], ref[0]), xy, v


def runner_predictions(poses, keep):
    """JAX's runner formula (``cpp/runner_common.hpp::extract_poses``) on
    (poses, keep) of one image: [(score, (n_kp, 3) [x, y, v])]."""
    found = []
    for pose, kept in zip(poses[0].cpu().numpy(), keep[0].cpu().numpy()):
        visible = pose[:, 0] > 0
        if not kept or not visible.any():
            continue
        score = np.float32(pose[visible, 0].sum(dtype=np.float32)
                           / np.float32(len(pose)))
        if score >= RUNNER_INSTANCE_THRESHOLD:
            found.append((float(score), pose[:, [1, 2, 0]]))
    return found


def prediction_diffs(line, found, label):
    """Largest (score, xy, confidence) differences of one runner JSON line
    from ``found`` (:func:`runner_predictions`); raises beyond
    RUNNER_ATOL or where the counts differ."""
    preds = line['predictions']
    if len(preds) != len(found):
        raise AssertionError(f'{label}: {len(preds)} predictions, the '
                             f'package\'s poses give {len(found)}')
    diffs = [0.0, 0.0, 0.0]
    for pred, (score, kps) in zip(preds, found):
        ours = np.asarray(pred['keypoints'], np.float64).reshape(-1, 3)
        diffs = [max(diffs[0], abs(pred['score'] - score)),
                 max(diffs[1], float(np.abs(ours[:, :2] - kps[:, :2]).max())),
                 max(diffs[2], float(np.abs(ours[:, 2] - kps[:, 2]).max()))]
    if not (diffs[0] <= RUNNER_ATOL['score'] and diffs[1] <= RUNNER_ATOL['xy']
            and diffs[2] <= RUNNER_ATOL['v']):
        raise AssertionError(f'{label}: (score, xy, v) differences {diffs} '
                             f'beyond {RUNNER_ATOL}')
    return diffs


def runner_launches(stderr, n_images, label):
    """The CifHr launches that a runner's ``--verbose`` reports, which
    must be one per image (the standard tier alone)."""
    found = re.search(r'cifhr kernel launches: (\d+)', stderr)
    launches = int(found.group(1)) if found else 0
    if launches != n_images:
        raise AssertionError(f'{label}: {launches} CifHr launches for '
                             f'{n_images} images:\n{stderr[-2000:]}')
    return launches


def write_ppm(path, pixels):
    with open(path, 'wb') as f:
        f.write(f'P6\n{pixels.shape[1]} {pixels.shape[0]}\n255\n'.encode()
                + np.ascontiguousarray(pixels, np.uint8).tobytes())


def runner_input(pixels, device):
    """The image runner's input of ``pixels`` (H, W, 3) uint8 without a
    resize: ``pifpaf_io.cpp``'s float32 normalisation, in numpy."""
    mean = np.float32([0.485, 0.456, 0.406])
    std = np.float32([0.229, 0.224, 0.225])
    x = (pixels.astype(np.float32) / np.float32(255) - mean) / std
    return torch.from_numpy(x.astype(np.float32))[None].to(device)


def lane_sums(poses, keep):
    """What the runner's ``--verbose`` prints on all lanes of (poses,
    keep) (``runner_common.hpp::print_lanes``): poses with a visible
    joint, kept, and the sums of v, x and y over lanes and joints in
    order, in double precision."""
    lanes = poses[0].double().cpu().numpy()
    flat = lanes.reshape(-1, 4)
    return (int((lanes[:, :, 0] > 0).any(axis=1).sum()), int(keep.sum()),
            *(float(np.add.accumulate(flat[:, c])[-1]) for c in range(3)))


def phase_package(port, started, images, device, card):
    """22b: the package and the fields package loaded in this process and
    run on ``images``: the fields package within PACKAGE_FIELDS_RTOL of
    each head's largest value of the eager module graph (TF32 off), and the
    package's (poses, keep) lane by lane within the pose gate of the eager
    ``build_cifcaf_decoder`` and of phase 20's decode-only ``.pt2``
    program on the fields package's fields (:func:`check_lanes`); every
    CifHr call a counted launch bit-equal to its plain version; NN plus
    decode ms per image and device ops and syncs of the package, the
    ``.pt2`` program and the eager decode. The random posed k16's decode
    is chaotic (1e-6 of noise in its fields moves many joints), so the
    package, whose NN Inductor computes in another order, is held to the
    eager decode on its own fields, and the end-to-end difference is
    reported. Returns (the package, its CifHr launches)."""
    from openpifpaf_tpu_torch.ops.decode_cifcaf import build_cifcaf_decoder
    from openpifpaf_tpu_torch.training import checkpoint

    model, _ = checkpoint.load_shell(started['ckpt'])
    model = model.to(device).eval()
    cif_meta, caf_meta = model.head_metas[:2]
    decode = build_cifcaf_decoder(stride=cif_meta.stride,
                                  skeleton=caf_meta.skeleton,
                                  n_keypoints=len(cif_meta.keypoints))
    decode_only = torch.export.load(started['program']).module()
    package, load_s = timed(torch._inductor.aoti_load_package,
                            started['package'])
    fields_package = torch._inductor.aoti_load_package(started['fields'])
    log(f'runner (22b) package loaded in {load_s:.2f} s (torch._inductor.'
        f'aoti_load_package) [{card}]')

    errs = []
    with no_tf32(), torch.no_grad():
        for i, image in enumerate(images):
            for o, r in zip(fields_package(image), model(image)):
                err = float((o - r).abs().max()) / float(r.abs().max())
                if not err <= PACKAGE_FIELDS_RTOL:
                    raise AssertionError(f'runner (22b) fields package, '
                                         f'image {i}: {err} of the largest '
                                         'value')
                errs.append(err)
    with torch.no_grad():
        tf32 = max(float((o - r).abs().max()) / float(r.abs().max())
                   for o, r in zip(fields_package(images[0]),
                                   model(images[0])))
    log(f'runner (22b) fields package: {len(images)} images within '
        f'{max(errs):.3g} of each head\'s largest value of the eager module '
        f'graph (gate {PACKAGE_FIELDS_RTOL:g}, TF32 off; {tf32:.3g} with TF32 '
        f'allowed) [{card}]')

    reset_launches(port)
    with kept_launches(port.cifhr_cuda) as calls, torch.no_grad():
        outs = [package(image) for image in images]
        torch.cuda.synchronize()
    launches = read_launches(port)['cifhr_accumulate']
    check_program_calls(port, calls, launches, len(images), 'runner (22b)')
    found, bits, worst, moved = [], {'eager': True, 'pt2': True}, {}, []
    with torch.no_grad():
        for i, (image, out) in enumerate(zip(images, outs)):
            if len(out) != 2 or tuple(out[0].shape[-2:]) != (17, 4):
                raise AssertionError(f'runner (22b): outputs '
                                     f'{[tuple(o.shape) for o in out]}')
            fields = fields_package(image)[:2]
            refs = {'eager': decode(*fields), 'pt2': decode_only(*fields)}
            for name, ref in refs.items():
                bit, xy, v = check_lanes(out, ref,
                                         f'runner (22b) image {i} vs {name}')
                bits[name] &= bit
                worst[name] = max(worst.get(name, (0.0, 0.0)), (xy, v))
            found.append((len(lane_poses(out[0])), int(out[1].sum())))
            end_to_end = decode(*model(image)[:2])
            moved.append(int(((out[0][0, ..., 0] > 0)
                              != (end_to_end[0][0, ..., 0] > 0)).sum()))
        fields = model(images[0])[:2]
        noisy = [f * (1 + 1e-6 * torch.randn(
            f.shape, device=f.device,
            generator=torch.Generator(f.device).manual_seed(0)))
            for f in fields]
        chaos = int(((decode(*noisy)[0][0, ..., 0] > 0)
                     != (decode(*fields)[0][0, ..., 0] > 0)).sum())
    if not sum(n for n, _ in found):
        raise AssertionError('runner (22b): no pose has a visible joint')
    log(f'runner (22b) package: (poses with a visible joint, kept) {found} '
        'per image; lane by lane within the pose gate of the eager '
        'build_cifcaf_decoder and of phase 20\'s decode-only .pt2 program '
        'on the fields package\'s fields, keep and order equal; bit-equal '
        f'to eager {bits["eager"]}, to the .pt2 {bits["pt2"]}; largest (xy '
        f'px, confidence) differences {worst}; its {len(calls)} CifHr calls '
        'launched the kernel, each map bit-equal to the plain version. End '
        'to end against the eager module graph and decode (not gated): '
        f'{moved} joints per image differ in visibility; the eager decode '
        f'of image 0\'s fields times (1 + 1e-6 noise) moves {chaos} [{card}]')

    reset_launches(port)
    program = torch.export.load(started['pt2']).module()
    times = {'package': [], 'pt2 program': [], 'eager': []}
    with torch.no_grad():
        for image in images:
            times['package'].append(event_ms(lambda: package(image)))
            times['pt2 program'].append(event_ms(lambda: program(image)))
            times['eager'].append(event_ms(
                lambda: decode(*model(image)[:2])))
        launches += read_launches(port)['cifhr_accumulate']
        profiles = {
            'package': decode_profile(lambda: package(images[0])),
            'pt2 program': decode_profile(lambda: program(images[0])),
            'eager': decode_profile(lambda: decode(*model(images[0])[:2]))}
    log('runner (22b) NN plus decode, ms per image (CUDA events, median of '
        f'{len(images)} images): '
        + ', '.join(f'{k} {np.median(v):.2f} (min {min(v):.2f}, max '
                    f'{max(v):.2f})' for k, v in times.items())
        + '; image 0 (device ops, stream syncs, device busy ms): '
        + ', '.join(f'{k} ({p[0]}, {p[1]}, {p[2]:.3f})'
                    for k, p in profiles.items()) + f' [{card}]')
    return package, launches


#: the runner's ``--verbose`` line on all lanes of an image
LANES_LINE = re.compile(r'^(.+): lanes (\d+) with a visible joint, (\d+) '
                        r'kept, sums v (\S+) x (\S+) y (\S+)$', re.M)


def phase_cpp_runner(made, package, files, device, card):
    """22c: the image runner on ``files`` written as PPM at their own size
    (no resize), against the Python-loaded package (``package``: the
    loaded package and its path) on the same input: every lane equal
    (:func:`lane_sums` of its ``--verbose`` lines, exactly) and one JSON
    line per image equal, to the printed precision, to the package's kept
    poses through JAX's extraction formula; its wall seconds and its C++
    operator's CifHr launches, one per image. Returns its launches."""
    import PIL.Image

    ppm, inputs = [], []
    for path in files:
        pixels = np.asarray(PIL.Image.open(path).convert('RGB'))
        ppm.append(path.rsplit('.', 1)[0] + '.ppm')
        write_ppm(ppm[-1], pixels)
        inputs.append(runner_input(pixels, device))
    done, wall = timed(subprocess.run,
                       [made.image, '--model', package[1], '--input-height',
                        str(IMAGE_HW[0]), '--input-width', str(IMAGE_HW[1]),
                        '--verbose', *ppm], capture_output=True, text=True,
                       timeout=600, check=False)
    lines = done.stdout.strip().splitlines()
    sums = {m[0]: (int(m[1]), int(m[2]), *map(float, m[3:]))
            for m in LANES_LINE.findall(done.stderr)}
    if done.returncode != 0 or len(lines) != len(ppm) or \
            sorted(sums) != sorted(ppm):
        raise AssertionError(f'runner (22c): exit {done.returncode}, '
                             f'{len(lines)} lines, {len(sums)} lane lines for '
                             f'{len(ppm)} images:\n{done.stdout[-2000:]}'
                             f'{done.stderr[-4000:]}')
    launches = runner_launches(done.stderr, len(ppm), 'runner (22c)')
    per_image = [float(m) for m in re.findall(r'load and run ([\d.]+) ms',
                                              done.stderr)]
    diffs, lanes = [0.0, 0.0, 0.0], []
    with torch.no_grad():
        for path, line, image in zip(ppm, lines, inputs):
            line = json.loads(line)
            if line['file'] != path:
                raise AssertionError(f'runner (22c): line for '
                                     f'{line["file"]}, expected {path}')
            out = package[0](image)
            ours = lane_sums(*out)
            if sums[path] != ours:
                raise AssertionError(f'runner (22c) {path}: the runner\'s '
                                     f'lanes {sums[path]}, the package\'s in '
                                     f'Python {ours}')
            lanes.append(ours[:2])
            diffs = [max(a, b) for a, b in zip(diffs, prediction_diffs(
                line, runner_predictions(*out),
                f'runner (22c) {os.path.basename(path)}'))]
    if not sum(n for n, _ in lanes):
        raise AssertionError('runner (22c): no pose has a visible joint')
    log(f'runner (22c) openpifpaf-tpu-torch-image over {len(ppm)} '
        f'{IMAGE_HW[0]}x{IMAGE_HW[1]} PPMs: (poses with a visible joint, '
        f'kept) {lanes}; every lane equal to the Python-loaded package\'s on '
        'the same normalised input (the sums of v, x and y over all lanes, '
        'exactly), each JSON line equal to its kept poses through JAX\'s '
        f'extraction formula within {RUNNER_ATOL} (the printed precision; '
        f'largest differences: score {diffs[0]:.3g}, xy {diffs[1]:.3g} px, '
        f'confidence {diffs[2]:.3g}); CifHr launched by the C++ operator '
        f'{launches} times, one per image; wall {wall:.2f} s for the list '
        '(process start and the package\'s load included), load and run '
        f'{np.mean(per_image[1:]):.2f} ms per image after the first '
        f'(first {per_image[0]:.2f}) [{card}]')
    return launches


def phase_video_runner(made, package, files, card):
    """22d: the video runner on a RUNNER_VIDEO_FRAMES-frame clip where it
    was built (it needs OpenCV); else a line saying why not."""
    if not made.video:
        log('runner (22d): the video runner was not built: CMake found no '
            f'OpenCV on this machine (build {made.tool}) [{card}]')
        return 0
    import cv2
    import PIL.Image

    clip = os.path.join(os.path.dirname(files[0]), 'clip.avi')
    first = np.asarray(PIL.Image.open(files[0]).convert('RGB'))
    writer = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*'MJPG'), 10.0,
                             (first.shape[1], first.shape[0]))
    for path in files[:RUNNER_VIDEO_FRAMES]:
        writer.write(np.asarray(PIL.Image.open(path).convert('RGB'))
                     [:, :, ::-1].copy())
    writer.release()
    done = subprocess.run([made.video, '--model', package, '--source', clip,
                           '--input-height', str(IMAGE_HW[0]),
                           '--input-width', str(IMAGE_HW[1]), '--verbose'],
                          capture_output=True, text=True, timeout=600,
                          check=False)
    lines = done.stdout.strip().splitlines()
    if done.returncode != 0 or [json.loads(x)['frame'] for x in lines] != \
            list(range(RUNNER_VIDEO_FRAMES)):
        raise AssertionError(f'runner (22d): exit {done.returncode}, '
                             f'{len(lines)} lines:\n{done.stderr[-3000:]}')
    launches = runner_launches(done.stderr, RUNNER_VIDEO_FRAMES,
                               'runner (22d)')
    log(f'runner (22d) openpifpaf-tpu-torch-video on a '
        f'{RUNNER_VIDEO_FRAMES}-frame clip: one line per frame, '
        f'{launches} CifHr launches [{card}]')
    return launches


def phase_runner(port, started, device, card):
    """Phase 22: (a) the package's export and the runner's build, started
    after phase 11 (they run beside phases 12-21); (b) the package in
    this process; (c) the image runner; (d) the video runner. Returns
    {kernel: launches} of (b)-(d), the runners' counted by the C++
    operator."""
    t0 = time.perf_counter()
    export_wall = started['export'].result()
    fields_wall = started['export_fields'].result()
    made, build_s = started['build'].result()
    log(f'runner (22a) python -m openpifpaf_tpu_torch.export --format '
        f'savedmodel --with-decoder --checkpoint posed-k16 at '
        f'{IMAGE_HW[0]}x{IMAGE_HW[1]}: {export_wall:.1f} s wall (process '
        'start, checkpoint load, export, AOTInductor compile; beside phases '
        f'12-21), {os.path.getsize(started["package"])} bytes; without '
        f'--with-decoder (the fields) {fields_wall:.1f} s, '
        f'{os.path.getsize(started["fields"])} bytes; the C++ '
        f'runner built with {made.tool} in {build_s:.1f} s (beside them), '
        f'input {"JPEG and PPM" if made.jpeg else "PPM alone"} (jpeglib.h '
        f'{made.jpeg or "not found"}), CifHr operator with CUDA {made.cuda}, '
        f'video runner {"built" if made.video else "not built"} [{card}]')
    if not made.cuda:
        raise AssertionError('runner (22a): the operator was built without '
                             'cifhr.cu')
    files = write_pipe_requests(started['directory'])
    package, launches = phase_package(
        port, started, phase_images([files], device), device, card)
    launches += phase_cpp_runner(made, (package, started['package']), files,
                                 device, card)
    launches += phase_video_runner(made, started['package'], files, card)
    log(f'phase 22: CifHr launches {launches}; {time.perf_counter() - t0:.1f}'
        f' s after phase 21 [{card}]')
    return {'cifhr_accumulate': launches}


def kernel_entry(name, source, replaces, launches, rows, row):
    """One kernel's entry of the JSON line: times and bound of ``row``,
    the largest error of all ``rows``."""
    return {
        'name': name,
        'route': 'cuda',
        'source': f'openpifpaf_tpu_torch/csrc/{source}',
        'replaces': replaces,
        'launches': launches,
        'max_abs_err': max(r['err'] for r in rows),
        'ms': row['ms'],
        'plain_ms': row['plain_ms'],
        'bound_ms': row['bound_ms'],
        'bound_by': row['bound_by'],
        'library_ms': row['library_ms'],
        'device_ms': row['device_ms'],
        'library_device_ms': row.get('library_device_ms'),
    }


def main():
    if not torch.cuda.is_available():
        sys.stderr.write('chip_smoke.py needs a CUDA device\n')
        sys.exit(2)
    device = torch.device('cuda:0')
    card = card_line()
    log(card)
    log(f'torch {torch.__version__} cuda {torch.version.cuda} on '
        f'{torch.cuda.get_device_name(0)}')

    port = import_port()
    began = time.perf_counter()

    def lap(phases):
        log(f'{phases} done at {time.perf_counter() - began:.1f} s [{card}]')

    phase_build(port)
    start_profiler()
    cifhr_rows = phase_kernel(port.cifhr, port.cifhr_cuda, device, card)
    backbone_results = phase_backbone_kernels(port, device, card)
    phase_golden(port.cifhr_cuda, device, card)
    phase_configs(port.cifhr_cuda, device, card)
    lap('phases 2-5b')
    predictor, cifhr_launches = phase_main_path(port, device, card)
    launches, predictors = phase_engines(port, predictor, device, card)
    launches['cifhr_accumulate'] = cifhr_launches
    launches['shuffle_branch2'] = phase_branch2(port, predictor, device,
                                                card)
    phase_profile(predictors, device, card)
    lab_results = phase_lab_kernels(port, device, card)
    launches.update(phase_lab(port, card))
    lap('phases 6-10')
    phase_train(port, device, card)
    lap('phase 11')
    with tempfile.TemporaryDirectory() as runner_dir, \
            ThreadPoolExecutor(3) as runner_pool:
        # phase 22's export compiles for minutes: it runs beside 12-21
        started = start_runner(runner_pool, runner_dir)
        launches['cifhr_accumulate'] += phase_other_backbones(port, device,
                                                              card)
        launches['cifhr_accumulate'] += phase_tracking(port, device, card)
        launches['cifhr_accumulate'] += phase_tracking_training(
            port, device, card)
        launches['cifhr_accumulate'] += phase_plugins_path(port, device,
                                                           card)
        lap('phases 12-15')
        for phase in (phase_detection, phase_mix, phase_reference,
                      phase_drawing):
            for name, count in phase(port, device, card).items():
                launches[name] += count
        lap('phases 16-19')
        for name, count in phase_deploy(port, device, card,
                                        runner_dir).items():
            launches[name] += count
        lap('phase 20')
        for name, count in phase_pipeline(port, device, card).items():
            launches[name] += count
        lap('phase 21')
        for name, count in phase_runner(port, started, device, card).items():
            launches[name] += count
        lap('phase 22')

    # no single PyTorch call computes the CifHr map; times at F=17 K=256
    entries = [kernel_entry('cifhr_accumulate', 'cifhr.cu',
                            'openpifpaf_tpu/ops/cifhr_pallas.py:53',
                            launches['cifhr_accumulate'], cifhr_rows,
                            cifhr_rows[0])]
    replaces = {
        'depthwise_conv': ('depthwise.cu', 'models/dw_pallas.py:38'),
        'shuffle_block': ('shuffle_block.cu', 'models/shuffle_pallas.py:108'),
        'shuffle_branch2': ('shuffle_block.cu', 'models/block_pallas.py:119'),
    }
    for name, (source, tpu) in replaces.items():
        rows = backbone_results[name]
        # times at the first stage's shape in float32
        entries.append(kernel_entry(name, source, f'openpifpaf_tpu/{tpu}',
                                    launches[name], rows, rows[0]))
    lab_replaces = {'lab_interleave': 56, 'lab_dw_valid': 84,
                    'lab_branch2': 124}
    for name, line in lab_replaces.items():
        rows = lab_results[name]
        # times at the lab's first stage in bfloat16, as the lab runs
        row = rows[len(port.mosaic_lab.STAGES)]
        entries.append(kernel_entry(name, LAB_SYMBOLS[name][0],
                                    f'tools/mosaic_lab.py:{line}',
                                    launches[name], rows, row))
    log(json.dumps({'kernels': entries}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu',
        'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count(),
    }}))


if __name__ == '__main__':
    main()
