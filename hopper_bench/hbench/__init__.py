"""The benchmark's harness: the manifest and the files it names, the
surrogate data, the window and its spans, the reading of the profiler's
trace, and the comparison that decides ``correct``."""
