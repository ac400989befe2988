"""The LM substrate of the port: layers, the MoE FFN, the four families
(transformer: dense, moe, vlm; zamba: hybrid; xlstm_lm: ssm; whisper: audio)
and ``model_zoo.get_model``."""
