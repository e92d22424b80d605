"""The checkpoint-name registry, ``resolve_checkpoint``, the restricted
unpickler, ``migrate`` and ``count_ops`` of the port against the JAX
package's.

Nothing here touches the network: downloads go through a mocked
``urllib.request.urlretrieve`` and the cache is a temporary directory
(``OPENPIFPAF_TPU_CACHE``). The unpickler's hostile pickles are loaded by
the port only.
"""

import argparse
import hashlib
import json
import os
import pickle
import sys
import types

import numpy as np
import pytest
import torch

import torch_ref
from openpifpaf_tpu import count_ops as jax_count_ops
from openpifpaf_tpu import datasets as jax_datasets
from openpifpaf_tpu import migrate as jax_migrate
from openpifpaf_tpu.models import factory as jax_factory
from openpifpaf_tpu_torch import count_ops, migrate, plugin
from openpifpaf_tpu_torch.models import convert_torch
from openpifpaf_tpu_torch.models import factory
from openpifpaf_tpu_torch.plugins.coco.constants import cocokp_head_metas
from openpifpaf_tpu_torch.training import checkpoint

from torch_port_helpers import one_torch_thread

#: the port's count of operations (convolutions and matmuls) against
#: XLA's (which adds the elementwise work): at most this share below
GFLOPS_RTOL = 0.01


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    one_torch_thread()


def registered(urls, unavailable):
    return ({k: v for k, v in urls.items() if v is not unavailable},
            sorted(k for k, v in urls.items() if v is unavailable))


def test_checkpoint_urls_equal_jax():
    plugin.register()
    ours = registered(factory.CHECKPOINT_URLS, factory.PRETRAINED_UNAVAILABLE)
    theirs = registered(jax_factory.CHECKPOINT_URLS,
                        jax_factory.PRETRAINED_UNAVAILABLE)
    assert ours == theirs
    assert len(ours[0]) == 18 and ours[1] == [
        'resnet101', 'resnet152', 'resnet18', 'shufflenetv2k44',
        'shufflenetv2x1', 'shufflenetv2x2', 'tshufflenetv2k16']
    import openpifpaf_tpu_torch
    assert openpifpaf_tpu_torch.CHECKPOINT_URLS is factory.CHECKPOINT_URLS
    assert openpifpaf_tpu_torch.PRETRAINED_UNAVAILABLE is \
        factory.PRETRAINED_UNAVAILABLE


# -- resolve_checkpoint -------------------------------------------------------

def _both(fn):
    """(the port's, JAX's) outcome of ``fn(resolve_checkpoint)``: the
    returned value or the raised exception's type and message."""
    out = []
    for resolve in (factory.resolve_checkpoint,
                    jax_factory.resolve_checkpoint):
        try:
            out.append(('value', fn(resolve)))
        except Exception as e:  # pylint: disable=broad-except
            out.append((type(e).__name__, str(e)))
    return out


def _fake_urlretrieve(contents, calls):
    def urlretrieve(url, filename):
        calls.append((url, filename))
        with open(filename, 'wb') as f:
            f.write(contents)
        return filename, None
    return urlretrieve


def _no_network(url, filename):
    raise AssertionError(f'download of {url} attempted')


@pytest.fixture
def cache(tmp_path, monkeypatch):
    directory = tmp_path / 'cache'
    monkeypatch.setenv('OPENPIFPAF_TPU_CACHE', str(directory))
    monkeypatch.setattr('urllib.request.urlretrieve', _no_network)
    plugin.register()
    return directory


def _register(monkeypatch, name, url):
    monkeypatch.setitem(factory.CHECKPOINT_URLS, name, url)
    monkeypatch.setitem(jax_factory.CHECKPOINT_URLS, name, url)


def test_resolve_local_path(cache, tmp_path):
    path = tmp_path / 'local.pkl'
    path.write_bytes(b'weights')
    port_ckpt = str(tmp_path / 'model')
    with open(port_ckpt + '.json', 'w') as f:
        f.write('{}')
    for arg in (str(path), port_ckpt, str(tmp_path / 'missing')):
        ours, theirs = _both(lambda resolve: resolve(arg))
        assert ours == theirs == ('value', arg)
    assert not cache.exists()


def test_resolve_unavailable_name_raises_with_jax_list(cache):
    ours, theirs = _both(lambda resolve: resolve('resnet18'))
    assert ours == theirs
    assert ours[0] == 'ValueError'
    assert "no pretrained weights published for 'resnet18'" in ours[1]
    assert "'shufflenetv2k16'" in ours[1]


def test_resolve_cache_hit(cache):
    """A registered name whose file is in the cache: no download, no hash
    check (the file name has no 8-hex suffix)."""
    cache.mkdir()
    local = cache / 'sk16_apollo_66kp.pkl'
    local.write_bytes(b'not checked')
    ours, theirs = _both(
        lambda resolve: resolve('shufflenetv2k16-apollo-66'))
    assert ours == theirs == ('value', str(local))


def test_resolve_hash_suffix(cache, monkeypatch):
    """A file name ``...-<8 hex>.pkl`` must prefix the sha256 of the
    cached file: the file passes, and with one byte changed it raises."""
    contents = b'reference checkpoint bytes'
    prefix = hashlib.sha256(contents).hexdigest()[:8]
    name = f'model-{prefix}.pkl'
    _register(monkeypatch, 'test-hashed', f'http://example.invalid/{name}')
    cache.mkdir()
    local = cache / name
    local.write_bytes(contents)
    ours, theirs = _both(lambda resolve: resolve('test-hashed'))
    assert ours == theirs == ('value', str(local))

    local.write_bytes(b'R' + contents[1:])
    ours, theirs = _both(lambda resolve: resolve('test-hashed'))
    assert ours == theirs
    assert ours[0] == 'ValueError' and 'hash mismatch' in ours[1]


def test_resolve_downloads_through_partial_file(cache, monkeypatch):
    """A name not yet in the cache downloads to ``<file>.partial`` and is
    renamed into place; the hash of the download is checked."""
    contents = b'downloaded weights'
    prefix = hashlib.sha256(contents).hexdigest()[:8]
    url = f'http://example.invalid/fetched-{prefix}.pkl'
    _register(monkeypatch, 'test-download', url)
    results = []
    for resolve in (factory.resolve_checkpoint,
                    jax_factory.resolve_checkpoint):
        calls = []
        monkeypatch.setattr('urllib.request.urlretrieve',
                            _fake_urlretrieve(contents, calls))
        local = cache / f'fetched-{prefix}.pkl'
        if local.exists():
            local.unlink()
        results.append((resolve('test-download'), calls))
        assert local.read_bytes() == contents
        assert not (cache / f'fetched-{prefix}.pkl.partial').exists()
    assert results[0] == results[1] == (
        str(cache / f'fetched-{prefix}.pkl'),
        [(url, str(cache / f'fetched-{prefix}.pkl.partial'))])


# -- the restricted unpickler -------------------------------------------------

FLAG_MODULE = 'checkpoint_names_test_flag'


class _Exec:
    def __reduce__(self):
        return exec, (f'import sys; sys.modules[{FLAG_MODULE!r}].hit = True',)


class _System:
    def __init__(self, flag_file):
        self.flag_file = flag_file

    def __reduce__(self):
        return os.system, (f'touch {self.flag_file}',)


@pytest.mark.parametrize('payload', ['exec', 'os.system'])
def test_hostile_pickle_raises_before_the_call(tmp_path, monkeypatch,
                                               payload):
    flag = types.ModuleType(FLAG_MODULE)
    flag.hit = False
    monkeypatch.setitem(sys.modules, FLAG_MODULE, flag)
    flag_file = tmp_path / 'flag'
    hostile = _Exec() if payload == 'exec' else _System(str(flag_file))
    path = str(tmp_path / 'hostile.pkl')
    torch.save({'model': hostile, 'epoch': 0}, path)

    with pytest.raises(pickle.UnpicklingError, match='not allowed'):
        convert_torch.load_torch_checkpoint(path)
    with pytest.raises(pickle.UnpicklingError, match='not allowed'):
        checkpoint.load_shell(path)
    assert flag.hit is False
    assert not flag_file.exists()


def test_every_reference_fixture_loads(tmp_path):
    """The fixtures' globals (torch's rebuilds, ``torch.nn`` classes,
    containers, ``argparse.Namespace``, numpy arrays in metas) resolve;
    the reference-layout classes become stubs."""
    builders = [lambda: torch_ref.build_shell('resnet18'),
                torch_ref.build_tracking_shell,
                lambda: torch_ref.build_shell(
                    'squeezenet', head_cls=torch_ref.CompositeField3)]
    for i, build in enumerate(builders):
        shell = build()
        shell.head_nets[0].meta.pose = np.arange(6.0).reshape(3, 2)
        path = str(tmp_path / f'{i}.pkl')
        torch.save({'model': shell, 'epoch': 2, 'meta': {
            'args': argparse.Namespace(device=torch.device('cpu'))}}, path)
        flat, epoch, meta, stub = convert_torch.load_torch_checkpoint(path)
        assert epoch == 2 and meta['args'].device == torch.device('cpu')
        assert isinstance(stub, convert_torch._Stub)  # pylint: disable=protected-access
        assert set(flat) == set(shell.state_dict())
        np.testing.assert_array_equal(
            convert_torch.head_metas_from_stub(stub)[0].pose,
            np.arange(6.0).reshape(3, 2))


# -- migrate ------------------------------------------------------------------

def _state_equal(a, b):
    assert set(a) == set(b)
    for name, value in a.items():
        assert torch.equal(value, b[name]), name


def test_migrate_reference_pickle_and_port_checkpoint(tmp_path):
    torch.manual_seed(3)
    shell = torch_ref.build_shell('mobilenetv3small')
    torch_ref.randomize_batch_norm_stats(shell)
    path = str(tmp_path / 'ref.pkl')
    torch.save({'model': shell, 'epoch': 5, 'meta': {}}, path)

    migrate.main(['--checkpoint', path])
    out = path + '.migrated'
    direct, direct_meta = checkpoint.load_shell(path)
    migrated, meta = checkpoint.load_shell(out)
    _state_equal(migrated.state_dict(), direct.state_dict())
    assert meta['base_name'] == direct_meta['base_name'] == 'mobilenetv3small'
    assert meta['epoch'] == 5
    assert meta['converted_from'] == os.path.abspath(path)
    assert meta['head_metas'] == json.loads(json.dumps(
        direct_meta['head_metas']))

    again = str(tmp_path / 'again')
    migrate.main(['--checkpoint', out, '--output', again])
    remigrated, remeta = checkpoint.load_shell(again)
    _state_equal(remigrated.state_dict(), migrated.state_dict())
    assert remeta == meta

    with pytest.raises(NotImplementedError):
        migrate.main(['--checkpoint', path, '--base-name', 'unknown',
                      '--output', str(tmp_path / 'bad')])


# -- count_ops ----------------------------------------------------------------

@pytest.mark.parametrize('edge', [161, 321])
def test_count_ops_matches_jax(edge):
    """Parameters equal; GFLOPs at most GFLOPS_RTOL below XLA's count."""
    import jax
    metas = jax_datasets.factory('cocokp').head_metas
    model, init = jax_factory.Factory(
        base_name='shufflenetv2k16').from_scratch(metas)
    jax_gflops, jax_params = jax_count_ops.count(
        model, init(jax.random.PRNGKey(0)), input_shape=(1, edge, edge, 3))
    port_model = factory.Factory('shufflenetv2k16').from_scratch(
        cocokp_head_metas())
    gflops, params = count_ops.count(port_model,
                                     input_shape=(1, edge, edge, 3))
    assert params == jax_params
    assert gflops <= jax_gflops
    assert gflops >= (1.0 - GFLOPS_RTOL) * jax_gflops, (gflops, jax_gflops)


def test_count_ops_cli(tmp_path, monkeypatch, capsys):
    torch.manual_seed(0)
    path = str(tmp_path / 'ref.pkl')
    torch.save({'model': torch_ref.build_shell('squeezenet'), 'epoch': 0,
                'meta': {}}, path)
    counted = []
    count = count_ops.count

    def small_count(model, *, device):
        counted.append(device)
        return count(model, input_shape=(1, 65, 65, 3), device=device)

    monkeypatch.setattr(count_ops, 'count', small_count)
    gflops, params = count_ops.main(['--checkpoint', path, '--device', 'cpu'])
    lines = capsys.readouterr().out.splitlines()
    assert lines == [f'GFLOPS: {gflops:.2f}',
                     f'million parameters: {params:.2f}']
    assert counted == ['cpu'] and gflops > 0
    n_params = sum(v.numel() for k, v in torch_ref.build_shell(
        'squeezenet').state_dict().items() if 'running' not in k
        and 'num_batches' not in k)
    assert params == n_params / 1e6
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            count_ops.main(['--checkpoint', path])


# -- flags --------------------------------------------------------------------

class _Parsed(Exception):
    pass


def _option_strings(main, argv):
    """The option strings of the parser that ``main`` builds."""
    seen = set()
    parse_args = argparse.ArgumentParser.parse_args

    def intercept(self, *args, **kwargs):
        for action in self._actions:  # pylint: disable=protected-access
            seen.update(s for s in action.option_strings
                        if s not in ('-h', '--help'))
        raise _Parsed

    argparse.ArgumentParser.parse_args = intercept
    try:
        old_argv = sys.argv
        sys.argv = ['prog'] + argv
        try:
            main()
        except _Parsed:
            pass
    finally:
        argparse.ArgumentParser.parse_args = parse_args
        sys.argv = old_argv
    return seen


@pytest.mark.parametrize('name', ['migrate', 'count_ops'])
def test_flags_equal_jax(name):
    """The same flags as the JAX package's CLI; count_ops adds the port's
    ``--device``, as the port's other CLIs do."""
    port_main = {'migrate': migrate.main, 'count_ops': count_ops.main}[name]
    jax_main = {'migrate': jax_migrate.main,
                'count_ops': jax_count_ops.main}[name]
    ours = _option_strings(port_main, [])
    theirs = _option_strings(jax_main, [])
    extra = {'--device'} if name == 'count_ops' else set()
    assert ours == theirs | extra
    assert len(theirs) == 3
