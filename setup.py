"""Build shim: compiles the native output-path extension.

The extension is optional — cuburn_tpu falls back to zlib/numpy when it
isn't present — so build errors degrade to a warning instead of failing
the install.
"""

import sys

from setuptools import setup
from setuptools.command.build_ext import build_ext
from setuptools.extension import Extension


class OptionalBuildExt(build_ext):
    def run(self):
        try:
            super().run()
        except Exception as e:  # pragma: no cover
            print(f"warning: native extension build failed ({e}); "
                  "falling back to pure-Python output path",
                  file=sys.stderr)

    def build_extension(self, ext):
        try:
            super().build_extension(ext)
        except Exception as e:  # pragma: no cover
            print(f"warning: building {ext.name} failed ({e})",
                  file=sys.stderr)


setup(
    ext_modules=[
        Extension(
            "cuburn_tpu.native.fastout",
            sources=["cuburn_tpu/native/fastout.c"],
            libraries=["z"],
            extra_compile_args=["-O3"],
        )
    ],
    cmdclass={"build_ext": OptionalBuildExt},
)
