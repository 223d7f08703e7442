"""Training: the optimizer, the train state and the WeDetect-Ref SFT
steps (stage 3 focal loss, stages 1-2 LM loss)."""
