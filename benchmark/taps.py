"""Observation points on the program's functions, installed from the
benchmark's side: a wrapper around a module-level function that calls
through and then hands (args, kwargs, result) to each listener, and, in a
traced run, a profiler span named after the function around the call."""
from __future__ import annotations

import functools
import importlib


class Taps:
    def __init__(self):
        self._installed = {}        # "module:function" -> (module, original)
        self._listeners = {}        # "module:function" -> [callable]
        self._spans = set()

    def _install(self, target: str):
        if target in self._installed:
            return
        mod_name, fn_name = target.split(":")
        module = importlib.import_module(mod_name)
        original = getattr(module, fn_name)
        listeners = self._listeners.setdefault(target, [])
        spans = self._spans
        span_name = self.span_name(target)

        @functools.wraps(original)
        def wrapper(*args, **kwargs):
            if target in spans:
                import torch
                with torch.profiler.record_function(span_name):
                    result = original(*args, **kwargs)
            else:
                result = original(*args, **kwargs)
            for listen in listeners:
                listen(args, kwargs, result)
            return result
        setattr(module, fn_name, wrapper)
        self._installed[target] = (module, original)

    @staticmethod
    def span_name(target: str) -> str:
        """The profiler span of "wenet_tpu_torch.ops.fsk:demod_raw":
        "ops.fsk.demod_raw"."""
        mod_name, fn_name = target.split(":")
        return ".".join(mod_name.split(".")[-2:] + [fn_name])

    def listen(self, target: str, fn):
        """Call fn(args, kwargs, result) after every call of target
        ("package.module:function")."""
        self._install(target)
        self._listeners[target].append(fn)

    def span(self, target: str):
        """Record a profiler span around every call of target."""
        self._install(target)
        self._spans.add(target)

    def close(self):
        for target, (module, original) in self._installed.items():
            setattr(module, target.split(":")[1], original)
        self._installed.clear()
        self._listeners.clear()
        self._spans.clear()
