"""The GAN stack's image-generation path (mirrors tise_tpu/models/): the
AttnGAN++ and CounterModel generators, the ``generate`` and ``gen_example``
CLIs, the attention grids and the generation bench's chain.  Forward only:
training waits for its own slice."""
