"""The plain reference: a Conformer-Transducer, its loss, decoding and optimizer in plain PyTorch; nothing of the program under test."""
