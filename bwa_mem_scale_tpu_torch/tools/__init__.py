"""Entry points that probe the card: ``probe_cuda`` and
``probe_cuda_rates``, the counterparts of ``tools/probe_pallas.py`` and
``tools/probe_pallas_rates.py``."""
