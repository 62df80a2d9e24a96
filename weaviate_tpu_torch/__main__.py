"""``python -m weaviate_tpu_torch`` — start the server on the CUDA card."""

from weaviate_tpu_torch.server import main

if __name__ == "__main__":
    main()
