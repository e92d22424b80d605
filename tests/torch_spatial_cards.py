"""The spatial mesh across four cards (or four gloo ranks on the CPU);
imports torch, never JAX:

    python3 tests/torch_spatial_cards.py [--cpu]

It needs a machine with four cards (``chip_smoke.py`` needs one and runs
every shard on it). It checks:

(a) Predictor(n_devices=4, spatial_devices=2) in one process, the shards on
    4 devices (2 images at a time, each over 2), on the module graph,
    dwpallas and pallas, against the same engine on one device;
(b) 4 ranks (data 2 x space 2), NCCL (gloo with --cpu), 2 Trainer steps of
    the full-width k16 on a global batch of 4 at 129 px, against one
    process with the height over 2 shards on one device: each rank's
    losses equal, within rel 1e-4 of the one-process run, and the
    parameters' checksum too.
"""
import os
import socket
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, 'tests')]

CPU = '--cpu' in sys.argv
N = 4
SPATIAL = 2
HW = 129
BATCH = 4
STEPS = 2


def device_of(rank):
    return torch.device('cpu') if CPU else torch.device('cuda', rank)


def metas():
    from torch_port_helpers import port_metas
    return port_metas(16)


def model():
    from openpifpaf_tpu_torch.models.factory import Factory
    return Factory().from_scratch(metas(),
                                  generator=torch.Generator().manual_seed(0))


def batch():
    rng = np.random.RandomState(7)
    images = rng.randn(BATCH, HW, HW, 3).astype(np.float32)
    fh = (HW - 1) // 16 + 1
    cif = (0.1 * rng.randn(BATCH, 17, 5, fh, fh)).astype(np.float32)
    caf = (0.1 * rng.randn(BATCH, 19, 9, fh, fh)).astype(np.float32)
    return images, cif, caf


def trainer(device, group=None):
    from openpifpaf_tpu_torch.training import losses, optimize
    from openpifpaf_tpu_torch.training.trainer import Trainer
    from torch_port_helpers import optimizer_args
    optimizer, schedule = optimize.factory_optimizer(
        optimizer_args(lr=1e-3, lr_warm_up_factor=1.0),
        training_batches_per_epoch=1)
    return Trainer(model(), losses.Factory().factory(metas()), optimizer,
                   schedule, 'unused', device=device, process_group=group,
                   spatial=SPATIAL)


def steps(t, images, cif, caf):
    device = t.device
    out = []
    for _ in range(STEPS):
        loss, _ = t.train_step(torch.from_numpy(images).to(device),
                               (torch.from_numpy(cif).to(device),
                                torch.from_numpy(caf).to(device)))
        out.append(float(loss))
    checksum = float(sum(p.detach().double().abs().sum()
                         for p in t.model.parameters()))
    return out, checksum


def rank_main(rank, port, out_dir):
    torch.set_num_threads(2)
    if not CPU:
        torch.cuda.set_device(rank)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group('gloo' if CPU else 'nccl',
                            init_method=f'tcp://localhost:{port}',
                            world_size=N, rank=rank)
    from openpifpaf_tpu_torch import parallel
    images, cif, caf = batch()
    mesh = parallel.GridMesh([device_of(rank)], SPATIAL, dist.group.WORLD)
    ((data, _),), (n_data, _) = mesh.cells(), mesh.shape
    per = BATCH // n_data
    part = slice(data * per, (data + 1) * per)
    t = trainer(device_of(rank), dist.group.WORLD)
    history, checksum = steps(t, images[part], cif[part], caf[part])
    torch.save({'history': history, 'checksum': checksum},
               os.path.join(out_dir, f'rank{rank}.pt'))
    dist.destroy_process_group()


def free_port():
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def phase_predictor():
    from openpifpaf_tpu_torch.predictor import Predictor
    m = model()
    image = np.random.RandomState(2).randint(
        0, 256, (2, 481, 641, 3)).astype(np.uint8)
    first = device_of(0)
    torch.backends.cudnn.allow_tf32 = False
    for engine in ('flax', 'dwpallas', 'pallas'):
        ref = Predictor(model=m, device=first, backbone_engine=engine)
        ours = Predictor(model=m, device=first, backbone_engine=engine,
                         n_devices=N, spatial_devices=SPATIAL)
        with torch.inference_mode():
            want = ref.fields_batch(image)
            got = ours.fields_batch(image)
        errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
        devices = sorted({str(p.device) for r in ours._sharded.replicas
                          for p in r.parameters()})
        print(f'(a) {engine}: {N} devices x spatial {SPATIAL}: fields vs '
              f'one device max abs err per head {errs}; replicas on '
              f'{devices}', flush=True)


def main():
    if not CPU:
        import subprocess
        print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True,
                             text=True).stdout, flush=True)
        assert torch.cuda.device_count() >= N, torch.cuda.device_count()
    t0 = time.perf_counter()
    phase_predictor()
    import tempfile
    with tempfile.TemporaryDirectory() as out_dir:
        torch.multiprocessing.start_processes(
            rank_main, args=(free_port(), out_dir), nprocs=N,
            start_method='spawn')
        ranks = [torch.load(os.path.join(out_dir, f'rank{r}.pt'))
                 for r in range(N)]
    if not CPU:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    single, checksum = steps(trainer(device_of(0)), *batch())
    print(f'(b) ranks (data {N // SPATIAL} x space {SPATIAL}): '
          f'{[r["history"] for r in ranks]}, checksums '
          f'{[r["checksum"] for r in ranks]}; one process {single}, '
          f'{checksum}', flush=True)
    assert all(r['history'] == ranks[0]['history'] for r in ranks)
    assert all(r['checksum'] == ranks[0]['checksum'] for r in ranks)
    np.testing.assert_allclose(ranks[0]['history'], single, rtol=1e-4)
    np.testing.assert_allclose(ranks[0]['checksum'], checksum, rtol=1e-4)
    print(f'ok in {time.perf_counter() - t0:.1f} s', flush=True)


if __name__ == '__main__':
    main()
