"""The plain reference the benchmark holds the port to: ``codd_torch``'s
model, losses and optimizer with every hand kernel's dispatch cut down
to the kernel's plain PyTorch form (the form the port's CPU tests hold
to ``codd_tpu``), frozen here so that the reference imports nothing of
the program and no later change to the program moves it."""
