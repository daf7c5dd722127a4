"""Deployment export: npz + manifest, ONNX, controller YAML."""
