"""Span targets, one file a layer of the program (``trace.Spans``)."""
