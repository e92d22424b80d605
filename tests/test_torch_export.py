"""``openpifpaf_tpu_torch.export``: the forward, and the forward with the
CifCaf decode, as one ``torch.export`` program, against the JAX package's
export (``openpifpaf_tpu/export.py``) and against the port's eager decode.

- Fields: the narrow shell's program (saved and loaded) against JAX's
  ``export._build_forward(with_decoder=False)`` under ``jax.jit``, within
  the forward parity tests' atol 1e-4.
- Decode: the decoder's program on the golden scenes (fields written with
  the JAX package) and the posed narrow shell's program on random images
  against JAX's ``build_cifcaf_decoder`` (``export``'s decode), under the
  tie-free pose gate (counts and visibility equal, xy within 1e-3 px,
  confidences within 2e-3); and bit-equal to the port's eager
  ``build_cifcaf_decoder`` on the same inputs.
- The program holds the decode's loops (three ``while_loop``s) and the
  CifHr operator, and no host read; it loads in a fresh process that
  imports only the port; the CLI runs with ``--device cpu`` and refuses
  what is not ported.
"""

import functools
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openpifpaf_tpu
from openpifpaf_tpu import export as jax_export
from openpifpaf_tpu.models.heads import CompositeField4
from openpifpaf_tpu.models.shell import Shell
from openpifpaf_tpu.ops import build_cifcaf_decoder as jax_build_decoder
from openpifpaf_tpu.plugins.coco.constants import COCO_PERSON_SKELETON
from openpifpaf_tpu_torch import export
from openpifpaf_tpu_torch.models import basenetworks, convert_jax
from openpifpaf_tpu_torch.models.factory import Factory
from openpifpaf_tpu_torch.ops.decode_cifcaf import build_cifcaf_decoder
from openpifpaf_tpu_torch.plugins.coco.constants import cocokp_head_metas

from torch_port_helpers import GOLDEN, GOLDEN_STRIDE, NARROW, \
    assert_pose_gate, golden_scenes, jax_f32, one_torch_thread, posed_head

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SKELETON = np.asarray(COCO_PERSON_SKELETON)
#: the forward parity tests' tolerance (test_torch_models.py)
FIELD_ATOL = 1e-4
IMAGE_HW = (97, 129)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    one_torch_thread()


@pytest.fixture(scope='module')
def models():
    """(JAX shell, its flax variables, its metas, the port's model) of one
    narrow ShuffleNetV2K with the cocokp heads made to decode to whole
    people (``posed_head``)."""
    metas = openpifpaf_tpu.datasets.factory('cocokp').head_metas
    base = openpifpaf_tpu.models.basenetworks.ShuffleNetV2K(
        stages_repeats=NARROW[0], stages_out_channels=NARROW[1])
    openpifpaf_tpu.models.shell.assign_strides(metas, base.stride)
    model = Shell(base_net=base, head_nets=tuple(
        CompositeField4(meta=m) for m in metas))
    variables = jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 65, 65, 3)), train=True))
    for i, meta in enumerate(metas):
        conv = variables['params'][f'head_nets_{i}']['Conv_0']
        conv['kernel'], conv['bias'] = posed_head(conv['kernel'],
                                                  conv['bias'], meta)
    port_model = Factory().from_scratch(
        cocokp_head_metas(), base_net=basenetworks.ShuffleNetV2K(*NARROW))
    port_model.load_state_dict(convert_jax.state_dict_from_jax(variables),
                               strict=True)
    return model, variables, metas, port_model.eval()


def _images(n, hw=IMAGE_HW, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(1, *hw, 3).astype(np.float32) for _ in range(n)]


@pytest.fixture(scope='module')
def posed_program(models, tmp_path_factory):
    """(path, program loaded back) of the posed narrow shell with the
    decoder, exported for the CPU and saved."""
    path = str(tmp_path_factory.mktemp('export') / 'posed.pt2')
    program = export.export_program(
        models[3], input_shape=(1, *IMAGE_HW, 3), with_decoder=True,
        device='cpu')
    torch.export.save(program, path)
    return path, torch.export.load(path)


class _Decode(torch.nn.Module):
    def __init__(self, decode):
        super().__init__()
        self.decode = decode

    def forward(self, cif, caf):
        return self.decode(cif, caf)


def _kept(poses, keep, order):
    """The kept poses of image 0 in score order, (n, 17, 4) [v, x, y, s]."""
    poses, keep, order = (np.asarray(a)[0] for a in (poses, keep, order))
    return poses[order][keep[order]]


def _port_decoder():
    return build_cifcaf_decoder(stride=GOLDEN_STRIDE, skeleton=SKELETON,
                                n_keypoints=17)


@functools.lru_cache(maxsize=None)
def _jax_decoder(stride):
    return jax_build_decoder(stride=stride, skeleton=SKELETON, n_keypoints=17)


def _jax_decode(cif, caf, stride=GOLDEN_STRIDE):
    with jax_f32():
        return [np.asarray(a) for a in _jax_decoder(stride)(
            jnp.asarray(cif), jnp.asarray(caf))]


@pytest.mark.parametrize('image_hw', [(65, 97), IMAGE_HW])
def test_fields_program_matches_jax(models, image_hw, tmp_path):
    model, variables, metas, port_model = models
    path = str(tmp_path / 'fields.pt2')
    torch.export.save(export.export_program(
        port_model, input_shape=(1, *image_hw, 3), device='cpu'), path)
    program = torch.export.load(path).module()
    image = _images(1, image_hw, seed=3)[0]
    with jax_f32():
        ref = jax.jit(jax_export._build_forward(
            model, variables, with_decoder=False, head_metas=metas))(
                jnp.asarray(image))
    ours = program(torch.from_numpy(image))
    assert len(ours) == len(ref) == 2
    for o, r in zip(ours, ref):
        assert o.shape == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r),
                                   atol=FIELD_ATOL, rtol=0)


@pytest.fixture(scope='module')
def decoder_program():
    """The port's decoder alone, exported on the golden fields' shape."""
    golden = np.load(GOLDEN)
    cif = torch.from_numpy(golden['sparse_cif'])[None]
    caf = torch.from_numpy(golden['sparse_caf'])[None]
    with torch.no_grad():
        return torch.export.export(_Decode(_port_decoder()), (cif, caf))


@pytest.mark.parametrize('scene', ['sparse', 'crowd'])
def test_decoder_program_matches_jax_on_golden_scenes(decoder_program,
                                                      scene):
    """The standard tier on both sides: the 40-person scene is not
    escalated, as in JAX's export."""
    cif, caf = golden_scenes()[scene][:2]
    ours = decoder_program.module()(torch.from_numpy(cif)[None],
                                    torch.from_numpy(caf)[None])
    ref = _jax_decode(cif[None], caf[None])
    assert [o.shape for o in ours] == [r.shape for r in ref]
    kept = _kept(*ours)
    assert len(kept) >= 3
    assert_pose_gate(list(kept), list(_kept(*ref)))


def test_decoder_program_bit_equal_to_eager(decoder_program):
    golden = np.load(GOLDEN)
    cif = torch.from_numpy(golden['sparse_cif'])[None]
    caf = torch.from_numpy(golden['sparse_caf'])[None]
    ours = decoder_program.module()(cif, caf)
    eager = _port_decoder()(cif, caf)
    for a, b in zip(ours, eager):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize('seed', [0, 1])
def test_posed_program_matches_jax(models, posed_program, seed):
    """Forward and decode in one program against JAX's forward and
    ``build_cifcaf_decoder`` (``export --with-decoder``'s program)."""
    model, variables, metas, _ = models
    image = _images(1, seed=seed)[0]
    ours = posed_program[1].module()(torch.from_numpy(image))
    with jax_f32():
        cif, caf = jax.jit(jax_export._build_forward(
            model, variables, with_decoder=False, head_metas=metas))(
                jnp.asarray(image))
    ref = _jax_decode(cif, caf, stride=metas[0].stride)
    kept = _kept(*ours)
    assert len(kept) >= 2
    assert_pose_gate(list(kept), list(_kept(*ref)))


@pytest.mark.parametrize('seed', [0, 1])
def test_posed_program_bit_equal_to_eager(models, posed_program, seed):
    port_model = models[3]
    image = torch.from_numpy(_images(1, seed=seed)[0])
    ours = posed_program[1].module()(image)
    with torch.no_grad():
        cif, caf = port_model(image)
        eager = build_cifcaf_decoder(
            stride=port_model.head_metas[0].stride, skeleton=SKELETON,
            n_keypoints=17)(cif, caf)
    for a, b in zip(ours, eager):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_posed_program_functionalizes_for_aotinductor(posed_program):
    """AOTInductor's first step, AOT autograd's functionalisation, takes
    the program: no loop's carried state aliases one of its operands
    (``seed_nms`` and ``nms_keypoints`` pass their start as an operand
    too; ``seeds._fixpoint`` hands the loop a copy). Before that repair
    ``aoti_compile_and_package`` stopped here with "cond_fn might be
    aliasing the input or the output"."""
    graph_module = posed_program[1].run_decompositions().graph_module
    targets = [str(n.target) for n in graph_module.graph.nodes
               if n.op == 'call_function']
    assert sum('while_loop' in t for t in targets) == 3


def _device_copies(graph_module):
    """{subgraph name: [(dtype, source op)]} of every ``.to(device)`` in
    the program and in its loops' subgraphs that moves a tensor to the
    CPU."""
    copies = {}
    for name, module in graph_module.named_modules():
        for node in module.graph.nodes:
            if node.op != 'call_function' or not str(node.target).startswith(
                    ('aten.to.', 'aten._to_copy')):
                continue
            if any(isinstance(a, torch.device) and a.type == 'cpu'
                   for a in (*node.args, *node.kwargs.values())):
                copies.setdefault(name, []).append(
                    (node.meta['val'].dtype, str(node.args[0].target)))
    return copies


def test_program_holds_the_loops_and_the_op(posed_program):
    """No host read: the three fixpoints are ``while_loop``s, the CifHr
    map one call of the port's operator, and no op of the program or of
    its loops' subgraphs reads a tensor's value or shape on the host. In
    each loop body the one copy to the CPU is the "changed?" flag that the
    loop's test reads (``seeds._fixpoint``): on the card, a copy to the
    host in each round (``test_torch_cuda.py`` checks that it is the only
    one there; on this CPU export the forward's moves to the program's
    device are copies to the CPU as well)."""
    graph_module = posed_program[1].graph_module
    targets = [str(n.target) for n in graph_module.graph.nodes
               if n.op == 'call_function']
    assert sum('while_loop' in t for t in targets) == 3
    assert targets.count('openpifpaf_tpu_torch.cifhr_accumulate.default') == 1
    for name, module in graph_module.named_modules():
        for node in module.graph.nodes:
            for host_read in ('aten.nonzero', 'aten._local_scalar_dense',
                              'aten.item', 'aten.sym_size'):
                assert not (node.op == 'call_function' and str(
                    node.target).startswith(host_read)), (name, host_read)
    copies = _device_copies(graph_module)
    assert {name: c for name, c in copies.items() if name} == {
        f'while_loop_body_graph_{i}': [(torch.bool, 'aten.any.default')]
        for i in range(3)}


_FRESH = r'''
import importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'openpifpaf_tpu'):
            raise ImportError('blocked: ' + name)
        return None

sys.meta_path.insert(0, Block())
import numpy as np, torch
import openpifpaf_tpu_torch
program = torch.export.load(sys.argv[1]).module()
data = np.load(sys.argv[2])
out = program(torch.from_numpy(data['image']))
for i, o in enumerate(out):
    assert torch.equal(o, torch.from_numpy(data[f'out{i}'])), i
print('ok', [tuple(o.shape) for o in out])
'''


def test_program_loads_in_a_fresh_process(posed_program, tmp_path):
    """Importing ``openpifpaf_tpu_torch`` registers the CifHr operator, so
    the saved program loads and runs with nothing else imported."""
    path, program = posed_program
    image = _images(1, seed=4)[0]
    out = program.module()(torch.from_numpy(image))
    data = str(tmp_path / 'io.npz')
    np.savez(data, image=image, **{f'out{i}': o.numpy()
                                   for i, o in enumerate(out)})
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1')
    done = subprocess.run([sys.executable, '-c', _FRESH, path, data],
                          cwd=str(tmp_path), env=env, capture_output=True,
                          text=True, timeout=300, check=False)
    assert done.returncode == 0, done.stderr[-3000:]
    assert done.stdout.startswith('ok [(1, 96, 17, 4), (1, 96), (1, 96)]')


def test_export_cli_on_cpu(tmp_path, capsys):
    """``python -m openpifpaf_tpu_torch.export --with-decoder --device
    cpu`` writes a program of a random model (seed 0) that returns (poses,
    keep, order)."""
    out = str(tmp_path / 'cli.pt2')
    export.main(['--with-decoder', '--device', 'cpu', '--basenet',
                 'shufflenetv2k16', '--input-height', '65',
                 '--input-width', '97', '--outfile', out])
    assert capsys.readouterr().out.strip() == f'wrote {out}'
    program = torch.export.load(out).module()
    poses, keep, order = program(torch.zeros((1, 65, 97, 3)))
    assert poses.shape == (1, 96, 17, 4) and keep.dtype == torch.bool
    assert order.shape == (1, 96)


@pytest.mark.parametrize('fmt,item', [('savedmodel', 'A13(h)'),
                                      ('tflite', 'A13(i)')])
def test_export_cli_refuses_the_tensorflow_formats(fmt, item, tmp_path,
                                                   monkeypatch):
    """JAX's two TensorFlow formats: tflite is not ported and raises,
    naming its ROADMAP item; savedmodel, ported by ROADMAP A13(h) as the
    C++ runner's AOTInductor package, is refused only where it has no
    device, as the other formats are: on a box without a card unless
    ``--device cpu`` (``test_torch_cpp_runner.py`` compiles it)."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    if fmt == 'tflite':
        with pytest.raises(NotImplementedError,
                           match=re.escape(f'ROADMAP {item}')):
            export.main(['--format', fmt, '--device', 'cpu', '--outfile',
                         str(tmp_path / 'x')])
    else:
        assert fmt not in export.NOT_PORTED
        with pytest.raises(RuntimeError, match='--device cpu'):
            export.main(['--format', fmt, '--outfile', str(tmp_path / 'x')])
    assert not os.path.exists(tmp_path / 'x')


def test_export_cli_needs_a_card_unless_told(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='--device cpu'):
        export.main(['--outfile', str(tmp_path / 'x.pt2')])
    assert not os.path.exists(tmp_path / 'x.pt2')
