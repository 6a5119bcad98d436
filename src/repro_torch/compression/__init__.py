"""KV compression: group quantization + multi-stream Huffman coding."""
