"""The LM substrate of the port: layers, the MoE FFN, the transformer family
(dense, moe, vlm) and ``model_zoo.get_model``."""
