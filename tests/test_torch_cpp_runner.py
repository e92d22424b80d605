"""The port's C++ runner (``openpifpaf_tpu_torch/cpp/``, built by
``openpifpaf_tpu_torch.cpp_runner``) and its input, ``export --format
savedmodel`` (an AOTInductor package of the ``(poses, keep)`` program).

- The CifHr operator's C++ launch plan (``csrc/cifhr_plan.h``), compiled
  with ``g++`` into a small C shim, equals ``ops/cifhr_cuda.py::plan``
  over the decode's shapes: a plan that differs is refused by the kernel.
- The operator's schema in ``csrc/cifhr_op.cpp`` is, letter for letter,
  the one ``openpifpaf_tpu_torch/__init__.py`` defines.
- The export CLI's savedmodel format: its program, its flags, its refusals.
- Marked ``slow`` (not in tier-1): the runner built for the CPU and run on
  a CPU package of the posed narrow shell, on a JPEG and a PPM, against the
  Python-loaded package and JAX's ``build_cifcaf_decoder``; the PPM-only
  build (the card's, which has no ``jpeglib.h``) refuses a JPEG.
"""

import ast
import ctypes
import json
import os
import re
import subprocess

import numpy as np
import pytest
import torch

from openpifpaf_tpu_torch import cpp_runner, export
from openpifpaf_tpu_torch.ops import cifhr_cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, 'openpifpaf_tpu_torch', 'csrc')

_SHIM = r'''
#include "cifhr_plan.h"

extern "C" int plan(int n_fields, int n_cells, int hr_h, int hr_w,
                    int groups, int bands_per_cta, int max_threads,
                    long long* out) {
    pifpaf::CifhrPlan p;
    const bool ok = groups < 0
        ? pifpaf::cifhr_plan(n_fields, n_cells, hr_h, hr_w, &p)
        : pifpaf::cifhr_plan(n_fields, n_cells, hr_h, hr_w, &p, groups,
                             bands_per_cta, max_threads);
    if (!ok) return 0;
    const long long values[8] = {p.groups, p.bands_per_cta, p.threads,
                                 p.chunks, p.bands, p.cap, p.smem, p.ctas};
    for (int i = 0; i < 8; ++i) out[i] = values[i];
    return 1;
}
'''

#: the CifHr maps the decode asks for: the k16's (stride 16) and a
#: stride-8 backbone's at the 481x641 input, the tests' 97x129 and
#: 65x97, the smoke's 513x641, and narrow and odd maps
MAPS = ((481, 641), (513, 641), (97, 129), (65, 97), (33, 41), (1, 1),
        (1, 33), (8, 32), (17, 1000), (721, 1281))
#: fields: the standard tier's 17, a detection head's 80, wholebody's 133
FIELDS = (1, 17, 80, 133)
#: cells: the budgets (256, 1024), the survivor list's rounds (512 per
#: round at 128 threads, 4096 at most) and past them
CELLS = (0, 1, 96, 256, 511, 512, 513, 1024, 4095, 4096, 4097, 6000)


@pytest.fixture(scope='module')
def plan_shim(tmp_path_factory):
    directory = tmp_path_factory.mktemp('plan')
    source = directory / 'shim.cpp'
    source.write_text(_SHIM)
    lib = directory / 'libshim.so'
    subprocess.run(['g++', '-O2', '-std=c++17', '-shared', '-fPIC',
                    f'-I{CSRC}', '-o', str(lib), str(source)], check=True,
                   capture_output=True, timeout=120)
    shim = ctypes.CDLL(str(lib))
    shim.plan.argtypes = [ctypes.c_int] * 7 + [
        ctypes.POINTER(ctypes.c_longlong)]
    shim.plan.restype = ctypes.c_int

    def plan(*args):
        out = (ctypes.c_longlong * 8)()
        if not shim.plan(*args, out):
            return None
        return cifhr_cuda.Plan(*(int(v) for v in out))
    return plan


def test_cpp_plan_equals_python_plan_at_the_decodes_shapes(plan_shim):
    n = 0
    for hr_h, hr_w in MAPS:
        for n_fields in FIELDS:
            for n_cells in CELLS:
                ours = plan_shim(n_fields, n_cells, hr_h, hr_w, -1, 0, 0)
                assert ours == cifhr_cuda.plan(n_fields, n_cells, hr_h,
                                               hr_w), (n_fields, n_cells,
                                                       hr_h, hr_w)
                n += 1
    assert n == len(MAPS) * len(FIELDS) * len(CELLS)


@pytest.mark.parametrize('groups,bands_per_cta,max_threads', [
    (1, 1, 32), (1, 4, 128), (2, 4, 128), (4, 2, 128), (2, 8, 256),
    (4, 1, 512), (8, 3, 1024), (16, 1, 512)])
def test_cpp_plan_equals_python_plan_off_the_defaults(
        plan_shim, groups, bands_per_cta, max_threads):
    for hr_h, hr_w in MAPS:
        for n_cells in (0, 256, 1024, 5000):
            ours = plan_shim(17, n_cells, hr_h, hr_w, groups,
                             bands_per_cta, max_threads)
            assert ours == cifhr_cuda.plan(
                17, n_cells, hr_h, hr_w, groups=groups,
                bands_per_cta=bands_per_cta, max_threads=max_threads)


@pytest.mark.parametrize('groups,bands_per_cta,max_threads', [
    (0, 4, 128), (5, 4, 128), (2, 0, 128), (2, 4, 32)])
def test_cpp_plan_refuses_what_the_python_plan_refuses(
        plan_shim, groups, bands_per_cta, max_threads):
    assert plan_shim(17, 256, 481, 641, groups, bands_per_cta,
                     max_threads) is None
    with pytest.raises(ValueError):
        cifhr_cuda.plan(17, 256, 481, 641, groups=groups,
                        bands_per_cta=bands_per_cta, max_threads=max_threads)


def _python_schema():
    """The namespace, name and schema that ``__init__.py`` defines."""
    with open(os.path.join(REPO, 'openpifpaf_tpu_torch', '__init__.py')) as f:
        tree = ast.parse(f.read())
    consts = {t.id: node.value.value for node in tree.body
              if isinstance(node, ast.Assign)
              and isinstance(node.value, ast.Constant)
              for t in node.targets}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(
                node.func, 'attr', None) == 'define':
            name = consts[node.args[0].id]
            return name, ast.literal_eval(node.args[1])
    raise AssertionError('no torch.library.define in __init__.py')


def test_cpp_operator_schema_is_the_python_one():
    with open(os.path.join(CSRC, 'cifhr_op.cpp')) as f:
        source = f.read()
    namespace = re.search(r'TORCH_LIBRARY\((\w+), m\)', source).group(1)
    literal = re.search(r'm\.def\(((?:\s*"[^"]*")+)\s*\)', source).group(1)
    cpp = ''.join(re.findall(r'"([^"]*)"', literal))
    name, schema = _python_schema()
    assert f'{namespace}::{cpp}' == name + schema
    for key in ('CPU', 'CUDA'):
        assert f'TORCH_LIBRARY_IMPL({namespace}, {key}, m)' in source
    # and the dispatcher's copy of the Python definition
    registered = torch.ops.openpifpaf_tpu_torch.cifhr_accumulate.default
    assert str(registered._schema) == f'{namespace}::{cpp}'


@pytest.mark.parametrize('decoder', [True, False])
def test_export_savedmodel_compiles_the_runners_program(monkeypatch,
                                                         tmp_path, capsys,
                                                         decoder):
    """``--format savedmodel`` hands AOTInductor the (poses, keep) program
    with the decoder and the fields without it (the compile itself is the
    slow test's)."""
    compiled = []

    def compile_package(program, outfile):
        compiled.append(program)
        with open(outfile, 'wb') as f:
            f.write(b'package')
        return outfile

    monkeypatch.setattr(export, 'compile_package', compile_package)
    out = str(tmp_path / 'k16-package.pt2')
    export.main(['--format', 'savedmodel', '--device', 'cpu',
                 '--input-height', '65', '--input-width', '97',
                 '--outfile', out] + ['--with-decoder'] * decoder)
    assert capsys.readouterr().out.strip() == f'wrote {out}'
    assert len(compiled) == 1
    outputs = compiled[0].module()(torch.zeros((1, 65, 97, 3)))
    if decoder:
        assert [tuple(o.shape) for o in outputs] == [(1, 96, 17, 4), (1, 96)]
        assert outputs[1].dtype == torch.bool
    else:
        assert [tuple(o.shape) for o in outputs] == [(1, 17, 5, 5, 7),
                                                     (1, 19, 8, 5, 7)]


def test_export_savedmodel_needs_a_card_unless_told(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    monkeypatch.setattr(export, 'compile_package', None)
    with pytest.raises(RuntimeError, match='--device cpu'):
        export.main(['--format', 'savedmodel', '--with-decoder',
                     '--outfile', str(tmp_path / 'x.pt2')])
    assert not os.path.exists(tmp_path / 'x.pt2')


def test_export_help_names_the_package(capsys):
    with pytest.raises(SystemExit):
        export.main(['--help'])
    text = ' '.join(capsys.readouterr().out.split())
    assert 'AOTInductor package' in text and "C++ runner's input" in text


def test_runner_build_is_keyed_on_its_sources():
    """Every source the build reads is in SOURCES, and nothing of the JAX
    package: the runner links none of it."""
    named = {os.path.relpath(p, REPO) for p in cpp_runner.SOURCES}
    assert named == {
        'openpifpaf_tpu_torch/cpp/CMakeLists.txt',
        'openpifpaf_tpu_torch/cpp/runner_common.hpp',
        'openpifpaf_tpu_torch/cpp/openpifpaf_image.cpp',
        'openpifpaf_tpu_torch/cpp/openpifpaf_video.cpp',
        'openpifpaf_tpu_torch/csrc/cifhr_op.cpp',
        'openpifpaf_tpu_torch/csrc/cifhr_plan.h',
        'openpifpaf_tpu_torch/csrc/cifhr.cu',
        'openpifpaf_tpu_torch/csrc/pifpaf_io.cpp'}
    for path in cpp_runner.SOURCES:
        with open(path) as f:
            text = f.read()
        code = '\n'.join(line.split('#' if path.endswith('.txt') else '//')[0]
                         for line in text.splitlines())
        assert not re.search(r'openpifpaf_tpu/|\.\./\.\.', code), path
        for include in re.findall(r'#include "([^"]+)"', text):
            assert os.path.exists(os.path.join(os.path.dirname(path),
                                               include)), (path, include)


def test_native_loader_reads_ppm_and_keeps_jpeg(tmp_path):
    """The port's loader reads binary PPM through the JPEG path's resize,
    pad and normalisation (the image runner's input where there is no
    libjpeg), and its JPEG path is unchanged: a PPM and a lossless-equal
    JPEG of the same pixels give the same batch."""
    from openpifpaf_tpu_torch.io import native
    if not native.native_available():
        pytest.skip('the native loader cannot be built here')
    import PIL.Image
    rng = np.random.RandomState(0)
    pixels = rng.randint(0, 255, (37, 53, 3), dtype=np.uint8)
    ppm = tmp_path / 'a.ppm'
    ppm.write_bytes(b'P6\n# a comment\n53 37\n255\n' + pixels.tobytes())
    jpeg = tmp_path / 'a.jpg'
    PIL.Image.fromarray(pixels).save(jpeg, quality=100, subsampling=0)
    decoded = np.asarray(PIL.Image.open(jpeg).convert('RGB'))
    ppm_decoded = tmp_path / 'b.ppm'
    ppm_decoded.write_bytes(b'P6 53 37 255\n' + decoded.tobytes())
    loader = native.NativeImageLoader(long_edge=33, pad_multiple=16)
    images, metas = loader.load_batch([str(ppm), str(jpeg),
                                       str(ppm_decoded)])
    assert [m['width_height'].tolist() for m in metas] == [[53, 37]] * 3
    assert np.array_equal(images[1], images[2])
    mean = np.float32([0.485, 0.456, 0.406])
    std = np.float32([0.229, 0.224, 0.225])
    assert float(np.abs(images[0] - images[1]).max()) <= float(
        np.abs(images[0]).max())
    corner = (pixels[0, 0] / np.float32(255) - mean) / std
    assert np.array_equal(images[0][0, 0], corner.astype(np.float32))


# ----------------------------------------------------------------------
# slow: the runner built and run on the CPU

IMAGE_HW = (97, 129)
MEAN = np.float32([0.485, 0.456, 0.406])
STD = np.float32([0.229, 0.224, 0.225])
INSTANCE_THRESHOLD = 0.15


@pytest.fixture(scope='module')
def cpu_package(tmp_path_factory):
    """(path, port model) of the posed narrow shell's (poses, keep)
    package for the CPU, and the JAX shell with its variables."""
    import jax
    import jax.numpy as jnp
    import openpifpaf_tpu
    from openpifpaf_tpu.models.heads import CompositeField4
    from openpifpaf_tpu.models.shell import Shell
    from openpifpaf_tpu_torch.models import basenetworks, convert_jax
    from openpifpaf_tpu_torch.models.factory import Factory
    from openpifpaf_tpu_torch.plugins.coco.constants import cocokp_head_metas
    from torch_port_helpers import NARROW, posed_head

    metas = openpifpaf_tpu.datasets.factory('cocokp').head_metas
    base = openpifpaf_tpu.models.basenetworks.ShuffleNetV2K(
        stages_repeats=NARROW[0], stages_out_channels=NARROW[1])
    openpifpaf_tpu.models.shell.assign_strides(metas, base.stride)
    shell = Shell(base_net=base, head_nets=tuple(
        CompositeField4(meta=m) for m in metas))
    variables = jax.tree_util.tree_map(np.asarray, shell.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 65, 65, 3)), train=True))
    for i, meta in enumerate(metas):
        conv = variables['params'][f'head_nets_{i}']['Conv_0']
        conv['kernel'], conv['bias'] = posed_head(conv['kernel'],
                                                  conv['bias'], meta)
    model = Factory().from_scratch(
        cocokp_head_metas(), base_net=basenetworks.ShuffleNetV2K(*NARROW))
    model.load_state_dict(convert_jax.state_dict_from_jax(variables),
                          strict=True)
    model.eval()
    path = str(tmp_path_factory.mktemp('package') / 'narrow.pt2')
    program = export.export_program(model, input_shape=(1, *IMAGE_HW, 3),
                                    with_decoder=True, device='cpu',
                                    n_outputs=2)
    export.compile_package(program, path)
    return path, model, metas


def _images(directory):
    """A PPM and a JPEG at IMAGE_HW with people the posed heads find."""
    import PIL.Image
    rng = np.random.RandomState(3)
    files = []
    for i, suffix in enumerate(('ppm', 'jpg')):
        pixels = rng.randint(0, 255, (*IMAGE_HW, 3), dtype=np.uint8)
        path = str(directory / f'image{i}.{suffix}')
        if suffix == 'ppm':
            with open(path, 'wb') as f:
                f.write(f'P6\n{IMAGE_HW[1]} {IMAGE_HW[0]}\n255\n'.encode()
                        + pixels.tobytes())
        else:
            PIL.Image.fromarray(pixels).save(path, quality=90)
        files.append(path)
    return files


def _native_input(path):
    """The runner's input tensor of ``path``: the port's loader (the same
    pifpaf_io.cpp) at IMAGE_HW, no resize."""
    from openpifpaf_tpu_torch.io import native
    lib = native._load_library()
    out = np.zeros((1, *IMAGE_HW, 3), np.float32)
    sizes = np.zeros((1, 4), np.int32)
    paths = (ctypes.c_char_p * 1)(path.encode())
    assert lib.pifpaf_load_batch(
        paths, 1, 0, IMAGE_HW[0], IMAGE_HW[1],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), 1) == 0
    return torch.from_numpy(out)


def _kept(poses, keep):
    """The kept poses of image 0 with a visible joint, (n_kp, 4) each."""
    return [p for p in poses[0].numpy()[keep[0].numpy()]
            if (p[:, 0] > 0).any()]


def _extract(poses, keep):
    """JAX's runner formula (cpp/runner_common.hpp::extract_poses) on the
    Python-loaded package's outputs: [(score, (n_kp, 3) [x, y, v])]."""
    found = []
    for pose, kept in zip(poses[0].numpy(), keep[0].numpy()):
        visible = pose[:, 0] > 0
        if not kept or not visible.any():
            continue
        score = np.float32(pose[visible, 0].sum(dtype=np.float32)
                           / np.float32(len(pose)))
        if score < INSTANCE_THRESHOLD:
            continue
        found.append((score, pose[:, [1, 2, 0]]))
    return found


@pytest.mark.slow
def test_cpu_runner_matches_the_python_package_and_jax(cpu_package,
                                                       tmp_path):
    import jax.numpy as jnp
    from openpifpaf_tpu.ops import build_cifcaf_decoder as jax_decoder
    from openpifpaf_tpu_torch.ops.decode_cifcaf import build_cifcaf_decoder

    from torch_port_helpers import assert_pose_gate, jax_f32

    path, model, metas = cpu_package
    made = cpp_runner.build(cuda=False)
    assert made.jpeg and not made.cuda
    files = _images(tmp_path)
    done = subprocess.run(
        [made.image, '--model', path, '--input-height', str(IMAGE_HW[0]),
         '--input-width', str(IMAGE_HW[1]), '--verbose', *files],
        capture_output=True, text=True, timeout=300, check=False)
    assert done.returncode == 0, done.stderr[-3000:]
    lines = [json.loads(line) for line in done.stdout.splitlines()]
    assert [line['file'] for line in lines] == files
    assert 'cifhr kernel launches: 0' in done.stderr   # the CPU loop
    # the package checks no shape: the runner refuses a size other than
    # the one in the package's metadata, and takes that one by default
    wrong = subprocess.run(
        [made.image, '--model', path, '--input-height', '65', files[0]],
        capture_output=True, text=True, timeout=300, check=False)
    assert wrong.returncode == 2 and 'the package takes 97x129' in \
        wrong.stderr, wrong.stderr[-2000:]
    default = subprocess.run([made.image, '--model', path, *files],
                             capture_output=True, text=True, timeout=300,
                             check=False)
    assert default.stdout == done.stdout

    import openpifpaf_tpu_torch  # noqa: F401 (the operator, for the package)
    package = torch._inductor.aoti_load_package(path)
    cif_meta, caf_meta = metas[:2]
    eager = build_cifcaf_decoder(stride=model.head_metas[0].stride,
                                 skeleton=caf_meta.skeleton, n_keypoints=17)
    reference = jax_decoder(stride=cif_meta.stride,
                            skeleton=np.asarray(caf_meta.skeleton),
                            n_keypoints=17)
    n_found = 0
    for file, line in zip(files, lines):
        image = _native_input(file)
        poses, keep = package(image)
        found = _extract(poses, keep)
        assert len(line['predictions']) == len(found)
        for pred, (score, kps) in zip(line['predictions'], found):
            assert abs(pred['score'] - float(score)) <= 5e-5 + 1e-6
            ours = np.asarray(pred['keypoints']).reshape(-1, 3)
            assert np.abs(ours[:, :2] - kps[:, :2]).max() <= 5e-3 + 1e-4
            assert np.abs(ours[:, 2] - kps[:, 2]).max() <= 5e-4 + 1e-6
        n_found += len(found)

        with torch.no_grad():
            cif, caf = model(image)
            ref_eager = eager(cif, caf)
        assert_pose_gate(_kept(poses, keep), _kept(*ref_eager[:2]))
        with jax_f32():
            ref = [torch.from_numpy(np.asarray(a)) for a in reference(
                jnp.asarray(cif.numpy()), jnp.asarray(caf.numpy()))]
        assert_pose_gate(_kept(poses, keep), _kept(*ref[:2]))
    assert n_found > 0, 'the posed heads found no pose'


@pytest.mark.slow
def test_ppm_only_runner_refuses_a_jpeg(cpu_package, tmp_path):
    """The card's configuration (no ``jpeglib.h``), built with the
    compilers alone, as where there is no ``cmake``."""
    made = cpp_runner.build(cuda=False, jpeg=False, tool='g++')
    assert not made.jpeg and made.tool == 'g++'
    ppm, jpeg = _images(tmp_path)
    done = subprocess.run(
        [made.image, '--model', cpu_package[0], '--input-height',
         str(IMAGE_HW[0]), '--input-width', str(IMAGE_HW[1]), ppm, jpeg],
        capture_output=True, text=True, timeout=300, check=False)
    assert done.returncode == 1
    assert [json.loads(line)['file'] for line in
            done.stdout.splitlines()] == [ppm]
    assert 'jpeglib.h' in done.stderr and jpeg in done.stderr
