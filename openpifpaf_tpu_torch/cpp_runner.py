"""Build of the port's C++ runner (``openpifpaf_tpu_torch/cpp/``).

Builds, from the sources in the package alone, the CifHr operator's
library (``csrc/cifhr_op.cpp``, with ``csrc/cifhr.cu`` for ``sm_90a`` where
torch is a CUDA build), the image runner (with ``csrc/pifpaf_io.cpp``) and,
where OpenCV is found, the video runner: LibTorch programs that run an
AOTInductor package of ``export --format savedmodel`` with no Python. The
build goes into the kernels' build directory (``--xla-compilation-cache``,
:mod:`.compile_cache`), keyed on the sources' bytes, the flags and the
torch version as :func:`._nvcc.cached_build` keys a kernel, so that an
unchanged checkout builds once. It runs CMake (``cpp/CMakeLists.txt``,
Torch found through ``torch.utils.cmake_prefix_path``) where ``cmake`` is
on the path, and otherwise the compilers with the same flags. Where
``jpeglib.h`` is not found the image runner reads binary PPM alone
(``-DPIFPAF_NO_JPEG``). A CUDA build needs ``nvcc``: it never builds the
operator without ``cifhr.cu``.

    python -m openpifpaf_tpu_torch.cpp_runner [--xla-compilation-cache DIR]

builds and prints the paths as one JSON line.
"""

import argparse
import concurrent.futures
import dataclasses
import hashlib
import json
import os
import shutil
import subprocess
import tempfile
import time

from . import _nvcc, compile_cache

CPP = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'cpp')
#: the runner's sources, which key the build
SOURCES = (os.path.join(CPP, 'CMakeLists.txt'),
           os.path.join(CPP, 'runner_common.hpp'),
           os.path.join(CPP, 'openpifpaf_image.cpp'),
           os.path.join(CPP, 'openpifpaf_video.cpp'),
           os.path.join(_nvcc.CSRC, 'cifhr_op.cpp'),
           os.path.join(_nvcc.CSRC, 'cifhr_plan.h'),
           os.path.join(_nvcc.CSRC, 'cifhr.cu'),
           os.path.join(_nvcc.CSRC, 'pifpaf_io.cpp'))
IMAGE = 'openpifpaf-tpu-torch-image'
VIDEO = 'openpifpaf-tpu-torch-video'
OP_LIBRARY = 'libopenpifpaf_cifhr_op.so'
#: the include directories searched for ``jpeglib.h``
JPEG_INCLUDES = ('/usr/include', '/usr/local/include',
                 '/usr/include/x86_64-linux-gnu')
OPENCV_INCLUDES = ('/usr/include/opencv4', '/usr/local/include/opencv4')
CXXFLAGS = ('-O3', '-std=c++17', '-fPIC')
#: the operator's own: no contracted multiply-add in the CPU loop
OP_CXXFLAGS = ('-ffp-contract=off',)
#: seconds one compiler or CMake step may take
STEP_TIMEOUT = 1200


@dataclasses.dataclass(frozen=True)
class Build:
    """What :func:`build` made (or found) in ``directory``."""
    directory: str
    image: str
    video: str           # '' where OpenCV was not found
    op_library: str
    cuda: bool           # the operator launches cifhr.cu
    jpeg: str            # the jpeglib.h used, '' for PPM input alone
    tool: str            # 'cmake' or 'g++'
    seconds: float       # of this build, 0.0 where it was found built

    def as_dict(self):
        return dataclasses.asdict(self)


def jpeg_header():
    """The path of ``jpeglib.h`` in JPEG_INCLUDES, or ''."""
    for directory in JPEG_INCLUDES:
        path = os.path.join(directory, 'jpeglib.h')
        if os.path.exists(path):
            return path
    return ''


def opencv_include():
    """The OpenCV 4 include directory with ``videoio.hpp``, or ''."""
    for directory in OPENCV_INCLUDES:
        if os.path.exists(os.path.join(directory, 'opencv2', 'videoio.hpp')):
            return directory
    return ''


def _torch():
    import torch
    import torch.utils
    from torch.utils import cpp_extension
    return torch, cpp_extension


def _run(cmd, cwd, log):
    start = time.perf_counter()
    done = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                          timeout=STEP_TIMEOUT, check=False)
    with open(log, 'a') as f:
        f.write(f'$ {" ".join(cmd)}  # {time.perf_counter() - start:.1f} s, '
                f'rc {done.returncode}\n{done.stdout}{done.stderr}\n')
    if done.returncode != 0:
        raise RuntimeError(f'C++ runner build: {os.path.basename(cmd[0])} '
                           f'failed ({done.returncode}):\n'
                           f'{done.stdout[-3000:]}{done.stderr[-6000:]}')


def _nvcc_path(cuda):
    if not cuda:
        return ''
    path = _nvcc._nvcc()
    if not os.path.exists(path):
        raise RuntimeError(f'C++ runner build: nvcc not found at {path}; '
                           'the CUDA operator needs cifhr.cu')
    return path


def _cmake(directory, cuda, jpeg, jobs, log):
    torch, _ = _torch()
    build_dir = os.path.join(directory, 'cmake')
    cmd = ['cmake', '-S', CPP, '-B', build_dir,
           f'-DCMAKE_PREFIX_PATH={torch.utils.cmake_prefix_path}',
           '-DCMAKE_BUILD_TYPE=Release',
           f'-DPIFPAF_CUDA={"ON" if cuda else "OFF"}',
           f'-DPIFPAF_JPEG={"ON" if jpeg else "OFF"}']
    if cuda:
        cmd.append(f'-DCMAKE_CUDA_COMPILER={_nvcc_path(cuda)}')
    _run(cmd, directory, log)
    _run(['cmake', '--build', build_dir, '-j', str(jobs)], directory, log)
    for name in (IMAGE, VIDEO, OP_LIBRARY):
        if os.path.exists(os.path.join(build_dir, name)):
            os.replace(os.path.join(build_dir, name),
                       os.path.join(directory, name))


def _compilers(directory, cuda, jpeg, jobs, log):
    """The build of ``cpp/CMakeLists.txt`` with the compilers alone."""
    torch, cpp_extension = _torch()
    lib_dirs = cpp_extension.library_paths()
    includes = [f'-I{d}' for d in cpp_extension.include_paths()]
    abi = f'-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}'
    libs = ['-Wl,--no-as-needed', *(f'-L{d}' for d in lib_dirs),
            *(f'-Wl,-rpath,{d}' for d in lib_dirs), '-ltorch',
            '-ltorch_cpu', '-lc10']
    if cuda:
        cuda_home = os.path.dirname(os.path.dirname(_nvcc_path(cuda)))
        includes.append(f'-I{os.path.join(cuda_home, "include")}')
        libs += ['-ltorch_cuda', '-lc10_cuda',
                 f'-L{os.path.join(cuda_home, "lib64")}', '-lcudart_static',
                 '-ldl', '-lrt']
    libs += ['-Wl,--as-needed', '-lpthread']
    cxx = ['g++', *CXXFLAGS, abi, *includes]

    def obj(source, *flags):
        out = os.path.join(directory,
                           os.path.basename(source) + '.o')
        if source.endswith('.cu'):
            _run([_nvcc_path(cuda), '-gencode',
                  'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
                  '-Xcompiler', '-fPIC', '-c', source, '-o', out],
                 directory, log)
        else:
            _run([*cxx, *flags, '-c', source, '-o', out], directory, log)
        return out

    csrc = _nvcc.CSRC
    video = opencv_include()
    jobs_list = [
        (os.path.join(csrc, 'cifhr_op.cpp'),
         *OP_CXXFLAGS, *(['-DPIFPAF_WITH_CUDA'] if cuda else [])),
        (os.path.join(CPP, 'openpifpaf_image.cpp'),),
        (os.path.join(csrc, 'pifpaf_io.cpp'),
         *([] if jpeg else ['-DPIFPAF_NO_JPEG'])),
    ]
    if cuda:
        jobs_list.append((os.path.join(csrc, 'cifhr.cu'),))
    if video:
        jobs_list.append((os.path.join(CPP, 'openpifpaf_video.cpp'),
                          f'-I{video}'))
    with concurrent.futures.ThreadPoolExecutor(jobs) as pool:
        objs = list(pool.map(lambda job: obj(*job), jobs_list))
    op_objs = [objs[0]] + ([objs[3]] if cuda else [])
    op_lib = os.path.join(directory, OP_LIBRARY)
    _run(['g++', '-shared', '-o', op_lib, *op_objs, *libs], directory, log)
    runner_libs = [f'-L{directory}', '-Wl,-rpath,$ORIGIN',
                   '-lopenpifpaf_cifhr_op', *libs]
    _run(['g++', '-o', os.path.join(directory, IMAGE), objs[1], objs[2],
          *runner_libs, *(['-ljpeg'] if jpeg else [])], directory, log)
    if video:
        _run(['g++', '-o', os.path.join(directory, VIDEO), objs[-1],
              *runner_libs, '-lopencv_core', '-lopencv_imgproc',
              '-lopencv_videoio'], directory, log)


def build(*, cuda=None, jpeg=None, tool=None, jobs=None):
    """Build the runner unless a build of these sources and flags is in
    the build directory; returns a :class:`Build`. ``cuda``: the
    operator's CUDA implementation (default where torch is a CUDA build);
    ``jpeg``: read JPEG (default where ``jpeglib.h`` is found); ``tool``:
    ``'cmake'`` (default where it is on the path) or ``'g++'``."""
    torch, _ = _torch()
    cuda = torch.version.cuda is not None if cuda is None else cuda
    jpeg = jpeg_header() if jpeg is None or jpeg else ''
    tool = tool or ('cmake' if shutil.which('cmake') else 'g++')
    jobs = jobs or min(8, os.cpu_count() or 1)
    digest = hashlib.sha256()
    for path in SOURCES:
        with open(path, 'rb') as f:
            digest.update(f.read())
    digest.update(' '.join((tool, str(cuda), jpeg, torch.__version__,
                            *CXXFLAGS, *OP_CXXFLAGS)).encode())
    directory = os.path.join(_nvcc.BUILD_DIR,
                             f'cpp_runner_{digest.hexdigest()[:16]}')

    def found(seconds):
        video = os.path.join(directory, VIDEO)
        return Build(directory=directory,
                     image=os.path.join(directory, IMAGE),
                     video=video if os.path.exists(video) else '',
                     op_library=os.path.join(directory, OP_LIBRARY),
                     cuda=cuda, jpeg=jpeg, tool=tool, seconds=seconds)

    if os.path.exists(os.path.join(directory, 'done')):
        return found(0.0)
    start = time.perf_counter()
    os.makedirs(_nvcc.BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix='cpp_runner.', dir=_nvcc.BUILD_DIR)
    try:
        (_cmake if tool == 'cmake' else _compilers)(
            work, cuda, jpeg, jobs, os.path.join(work, 'build.log'))
        for name in (IMAGE, OP_LIBRARY):
            if not os.path.exists(os.path.join(work, name)):
                raise RuntimeError(f'C++ runner build: {name} was not built')
        with open(os.path.join(work, 'done'), 'w') as f:
            f.write(f'{tool} cuda={cuda} jpeg={jpeg or "none"}\n')
        if os.path.exists(directory):
            shutil.rmtree(directory)
        os.replace(work, directory)
    except BaseException:
        shutil.rmtree(work, ignore_errors=True)
        raise
    return found(time.perf_counter() - start)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog='python3 -m openpifpaf_tpu_torch.cpp_runner',
        description='build the C++ runner and print its paths as JSON')
    compile_cache.cli(parser)
    args = parser.parse_args(argv)
    compile_cache.configure(args)
    print(json.dumps(build().as_dict()))


if __name__ == '__main__':
    main()
