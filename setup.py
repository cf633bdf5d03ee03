from setuptools import setup, find_packages

setup(
    name='chroma_tpu',
    version='0.1.0',
    description='TPU-native optical photon Monte Carlo (JAX/XLA)',
    packages=find_packages(include=['chroma_tpu', 'chroma_tpu.*',
                                    'chroma_tpu_torch',
                                    'chroma_tpu_torch.*']),
    package_data={
        'chroma_tpu.demo': ['data/*'],
        'chroma_tpu.color': ['*.csv'],
        'chroma_tpu.models': ['*.stl', '*.stl.bz2'],
        'chroma_tpu_torch': ['csrc/*.cu'],
    },
    scripts=[
        'bin/chroma-sim', 'bin/chroma-cam', 'bin/chroma-geo',
        'bin/chroma-bvh', 'bin/chroma-server', 'bin/chroma-server-rat',
        'bin/chroma-profile',
    ],
    install_requires=['numpy', 'jax', 'flax'],
    extras_require={
        'viewer': ['pygame', 'matplotlib'],
        'server': ['pyzmq'],
    },
    python_requires='>=3.10',
)
