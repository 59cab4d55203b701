"""The example drivers (counterparts of the repo's ``examples/``), one
module per JAX driver under the same name, each run as
``python -m dcnn_tpu_torch.examples.<name>``; ``launch_pipeline.sh``
starts a TCP pipeline of ``network_worker`` processes. Every driver runs
on the device ``DEVICE_TYPE`` names (``TrainingConfig.device_type``: CUDA
by default, ``cpu`` on request) and exits non-zero where CUDA is asked for
and no card is visible. Nothing here runs at import."""
