"""The plain PyTorch reference of the benchmark's cells: the models with
explicit BatchNorm, the losses, gradient, HVP and vGHv by autograd, the
damped power iteration and the optimizers.  It imports nothing of the
program under test and takes nothing it made."""
