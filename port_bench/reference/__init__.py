"""The plain reference: priors, models, a bootstrap filter and SMC², in
plain PyTorch or NumPy. It imports nothing of the program and takes
nothing the program made."""
