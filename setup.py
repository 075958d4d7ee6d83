from setuptools import setup, find_packages

setup(
    name="krylov-crn-tpu",
    version="0.1.0",
    description=(
        "Sparse second-order optimization framework for the GPU: "
        "Krylov cubic-regularized Newton methods in JAX/XLA/Pallas"
    ),
    packages=find_packages(include=["krylov_crn_tpu*"]),
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "scipy"],
)
