"""PyTorch/CUDA port of the user-centric FL system (`repro`, the JAX package).

Layout mirrors `repro` module for module, so each counterpart is found
under the same dotted name (``repro.fl.simulator.run_federated`` ->
``repro_torch.fl.simulator.run_federated``).  The two heavy contractions
of a round, Y = W Θ and the Gram matrix behind Δ, run in hand-written
CUDA kernels for Hopper (``repro_torch.kernels``); everything else is
plain PyTorch.

Entry points take ``device=`` and default to ``"cuda"``; without a card
they raise rather than run on the CPU (pass ``device="cpu"`` explicitly,
as the tests do).  The package imports nothing from JAX or from `repro`.
"""

# torch.func's first gradient imports torch._dynamo, and that import keeps
# the frames that called it (a whole run's locals, its data pages among
# them) in reference cycles until the cycle collector runs.  Imported
# with the package, it holds only import-time frames.
import torch._dynamo  # noqa: E402,F401
