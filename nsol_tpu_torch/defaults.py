"""Global constants and dtype policy (counterpart of ``nsol_tpu/defaults.py``).

The constants are the reference's (nsol/definitions.py:6-17). The dtype
policy follows torch's own default instead of JAX's x64 switch: float32
unless the caller has set float64 with ``torch.set_default_dtype``.
"""

EPS = 1e-10

#: File extension used for parameter-study text artifacts
#: (reference: nsol/definitions.py:14).
STUDY_FILE_EXTENSION = "txt"

#: Allowed input data extensions (reference: nsol/definitions.py:15).
ALLOWED_INPUT_EXTENSIONS = ("mat", "png", "nii", "nii.gz")

#: Supported noise corruption types (reference: nsol/definitions.py:16).
ALLOWED_NOISE_TYPES = ("gaussian", "poisson", "uniform", "salt_and_pepper")


def default_dtype():
    """Return the library default floating dtype (a ``torch.dtype``)."""
    import torch

    return torch.get_default_dtype()
