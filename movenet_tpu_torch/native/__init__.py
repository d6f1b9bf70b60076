"""Native C++ host library of the data layer: clip preprocessing and the
decode -> preprocess pipeline (``io_loader.cpp``, ``pipeline.cpp``; the
port's own copy of ``movenet_tpu/native``).  Host CPU code, no device
kernel; built with ``python -m movenet_tpu_torch.native.build`` and used
by ``data/preprocess.py`` and ``data/pipeline.py`` when built."""
