"""Packaging for infinistore-tpu.

Parity target: reference setup.py drives `make` in src/ during build
(/root/reference/setup.py:31-40) and installs an `infinistore` console
script (:68-71). Here the native library is built by `make -C native` into
infinistore_tpu/_native/ and shipped as package data.
"""

import os
import subprocess
from pathlib import Path

from setuptools import find_packages, setup
from setuptools.command.build_py import build_py

try:  # setuptools >= 70 vendors bdist_wheel; older installs use wheel's
    from setuptools.command.bdist_wheel import bdist_wheel
except ImportError:  # pragma: no cover - depends on tooling vintage
    try:
        from wheel.bdist_wheel import bdist_wheel
    except ImportError:
        # No wheel support at all (legacy `setup.py install`/`build`):
        # those commands never build a wheel, so the platform-tag
        # override simply has nothing to hook — don't make them die at
        # import time.
        bdist_wheel = None


class BuildWithNative(build_py):
    def run(self):
        native = Path(__file__).parent / "native"
        subprocess.run(["make", "-C", str(native)], check=True)
        if os.environ.get("ISTPU_TSAN") == "1":
            # Developer convenience: also produce the ThreadSanitizer
            # build (native/build/libinfinistore_tpu_tsan.so, loaded via
            # INFINISTORE_TPU_NATIVE_LIB — see run_test.sh). The wheel
            # still ships only the regular library: package_data globs
            # infinistore_tpu/_native/*.so and the sanitizer .so lives
            # outside the package tree by design.
            subprocess.run(["make", "-C", str(native), "tsan"], check=True)
        super().run()


_cmdclass = {"build_py": BuildWithNative}

if bdist_wheel is not None:
    class PlatformWheel(bdist_wheel):
        """Tag the wheel for the build platform, not `any`.

        The package ships a compiled libinfinistore_tpu.so as package
        data, so a py3-none-any tag is a lie — pip would happily install
        the x86_64 build on an aarch64 host and fail at dlopen time.
        ctypes binding does free us from per-CPython ABI tags (the .so
        has no libpython dependence), hence py3-none-<platform>: one
        wheel per platform, valid across CPython versions."""

        def finalize_options(self):
            super().finalize_options()
            self.root_is_pure = False

        def get_tag(self):
            _impl, _abi, plat = super().get_tag()
            return "py3", "none", plat

    _cmdclass["bdist_wheel"] = PlatformWheel


setup(
    name="infinistore-tpu",
    version="0.1.0",
    description="A TPU-native KV-cache memory pool",
    packages=find_packages(include=["infinistore_tpu", "infinistore_tpu.*",
                                    "infinistore_tpu_torch",
                                    "infinistore_tpu_torch.*"]),
    # The PyTorch port builds its store library and CUDA kernels on
    # first use, from native/src and its own csrc/ sources.
    package_data={"infinistore_tpu": ["_native/*.so"],
                  "infinistore_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    cmdclass=_cmdclass,
    python_requires=">=3.10",
    install_requires=["numpy"],
    extras_require={
        "tpu": ["jax"],
        "cuda": ["torch"],
        "train": ["optax", "orbax-checkpoint"],
        "test": ["pytest"],
    },
    entry_points={
        "console_scripts": [
            "infinistore-tpu = infinistore_tpu.server:main",
        ]
    },
)
