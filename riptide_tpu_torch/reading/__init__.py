"""Input-format readers: PRESTO .inf/.dat and SIGPROC .tim headers."""
from .presto import PrestoInf
from .sigproc import SigprocHeader, read_sigproc_header

__all__ = ["PrestoInf", "SigprocHeader", "read_sigproc_header"]
