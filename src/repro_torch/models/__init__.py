"""The LM stack (port of ``repro.models``): layers, attention, the dense
model."""
