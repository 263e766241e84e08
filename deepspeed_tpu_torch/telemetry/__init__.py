"""Telemetry of the port: the structured tracer (``trace.py``)."""

from .trace import Span, Tracer, configure_tracer, get_tracer  # noqa: F401
