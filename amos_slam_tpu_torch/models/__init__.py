"""YOLACT stage one: ResNet backbone, FPN, ProtoNet, fast-NMS detection and
the Segmenter that turns RGB frames into dynamic-object masks (port of the
JAX package's models/; its training and eval tools are not ported yet)."""
