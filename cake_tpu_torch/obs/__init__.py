"""Observability of the port: ``slo`` (per-tenant SLO tracking). The rest of
the reference's ``cake_tpu/obs/`` is ROADMAP.md queue A, observability."""
