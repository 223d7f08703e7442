"""Training: the optimizer, the train state, the detector's TAL
assigner, losses, train step and loop, and the WeDetect-Ref SFT steps
(stage 3 focal loss, stages 1-2 LM loss)."""
