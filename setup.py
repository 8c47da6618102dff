"""mmf_tpu packaging: console scripts mirror the reference CLI surface
(reference setup.py:154-161)."""

from setuptools import find_packages, setup

setup(
    name="mmf_tpu",
    version="0.1.0",
    description=(
        "TPU-native multimodal (vision+language) research framework on "
        "JAX/XLA/Pallas with the capabilities of facebookresearch/mmf"
    ),
    packages=find_packages(include=["mmf_tpu", "mmf_tpu.*", "tools",
                                    "tools.*", "mmf_tpu_torch",
                                    "mmf_tpu_torch.*"]),
    include_package_data=True,
    package_data={"mmf_tpu": ["configs/**/*.yaml", "utils/phoc/src/*.c",
                          "utils/native/src/*.c", "utils/native/src/*.cc"],
                  "mmf_tpu_torch": ["ops/csrc/*.cu", "ops/csrc/*.cuh"]},
    python_requires=">=3.10",
    install_requires=[
        "jax", "flax", "optax", "orbax-checkpoint", "numpy", "pyyaml",
        "transformers", "scikit-learn", "nltk", "pillow",
    ],
    entry_points={
        "console_scripts": [
            "mmf_run = mmf_tpu.cli.run:run",
            "mmf_predict = mmf_tpu.cli.predict:predict",
            "mmf_interactive = mmf_tpu.cli.interactive:interactive",
            "mmf_convert_hm = mmf_tpu.cli.hm_convert:main",
            "mmf_serve = mmf_tpu.cli.serve:serve",
        ]
    },
)
