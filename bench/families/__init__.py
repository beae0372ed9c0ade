"""Configuration families: ``bench/families/<family>.py`` holds what depends
on a configuration's layers (weights, the program, the plain reference,
the roofline counts), found through ``bench.core.spec.family``."""
