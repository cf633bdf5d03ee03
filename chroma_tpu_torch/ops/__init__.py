"""Device-side operations of the torch port (layout of chroma_tpu.ops)."""
import torch

# On the CPU, torch.sqrt of a tensor long enough to be split among threads
# calls MKL's vector math library from each thread. When that call is the
# process's first use of the library, the threads race its lazy
# initialisation, and now and then one thread's share comes back with
# only about 12 correct bits (relative errors up to 3e-4; in about 2% of
# fresh processes with two threads and 5,000 elements, never on a later
# call). One call on a single element, made here in the importing thread
# before any parallel one, initialises the library.
torch.sqrt(torch.ones(1))
