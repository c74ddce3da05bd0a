"""Probe entry points of the port, run on a CUDA device only:
``python -m hpclinalg_torch.tools.<name>`` with ``proto_dia``,
``dia_variants`` or ``probe_kpayload``."""
