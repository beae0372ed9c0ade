"""The plain reference of the int8 CNN engine. Imports nothing of the
port, of ``repro`` or of JAX."""
