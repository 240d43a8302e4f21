"""Observability of the port (copies of the reference's ``cake_tpu/obs/``):
``timeline`` (span trees, Chrome trace JSON), ``critpath`` (per-request
latency attribution, ``GET /explain``), ``efficiency`` (the goodput and
hardware-efficiency ledger and the decision audit), ``requestlog``,
``timeseries``, ``blackbox``, ``slo`` and the shared ``taxonomy``; the
metrics registry and flight recorder live in ``utils/metrics.py``. Not
ported (ROADMAP.md): ``jitwatch``, ``memwatch`` and ``utils/trace.py``
(A6), ``cluster`` (A3.3). Stdlib only but for ``efficiency``'s device
peaks, which ask torch for the card's name when asked."""
