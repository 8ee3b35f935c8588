"""The benchmark's plain references: plain PyTorch, independent of the
program under test."""
