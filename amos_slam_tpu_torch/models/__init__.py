"""YOLACT: ResNet backbone, FPN, ProtoNet, fast-NMS detection, the Segmenter
that turns RGB frames into dynamic-object masks, and the training and eval
tools (configs, data pipeline, multibox loss and SGD step, COCO-style mAP);
port of the JAX package's models/."""
