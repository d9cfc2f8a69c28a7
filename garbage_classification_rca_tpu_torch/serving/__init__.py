"""The serving layer: ``engine.GenerationServer``, continuous batching over
a fixed grid of slots, each request's stream equal to ``opt.generate`` run
on it alone."""

from .engine import GenerationServer, ServedRequest  # noqa: F401
