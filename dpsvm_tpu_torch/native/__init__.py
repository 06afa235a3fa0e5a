"""Native (C++) host helpers of the port, loaded through ctypes (port of
``dpsvm_tpu/native``): dense CSV and libsvm parsing. ``build.py``
compiles ``csv_loader.cpp`` at first use; ``last_path()`` says whether the
latest data load ran native or in Python."""

from dpsvm_tpu_torch.native.build import (build_native, last_path,
                                          load_native_lib, note_path)

__all__ = ["build_native", "last_path", "load_native_lib", "note_path"]
