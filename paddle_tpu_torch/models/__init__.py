"""Models of the port: GPT, BERT and the vision zoo (ResNet, VGG,
MobileNet, LeNet)."""
