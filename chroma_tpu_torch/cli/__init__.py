"""Command-line entry points of the torch port, counterparts of the bin/
scripts with the same arguments and output, plus --device where they run
the simulation:

    python -m chroma_tpu_torch.cli.sim DETECTOR OUT.chroma -n 10 -p 100000
    python -m chroma_tpu_torch.cli.geo {save,list,remove,default} ...
    python -m chroma_tpu_torch.cli.profile [DETECTOR] -p 262144 -n 3
    python -m chroma_tpu_torch.cli.server DETECTOR --address tcp://*:5024
    python -m chroma_tpu_torch.cli.server_rat DETECTOR -a ipc:///tmp/x

Geometry strings resolve through chroma_tpu_torch.loader (an STL file, a
cache name, or @python.module.obj such as @chroma_tpu_torch.demo.tiny);
the cache is CHROMA_CACHE_DIR (default ~/.chroma_tpu_torch)."""
