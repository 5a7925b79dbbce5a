"""The native DCN bridge of the proc tier, for the PyTorch port: the
port's C shim (``csrc/t4j_capi.cc``), its build (``build.py``) and the
ctypes runtime (``runtime.py``)."""
