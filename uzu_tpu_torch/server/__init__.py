from .batched import BatchedChatServer, serve_batched
from .openai import ChatCompletionServer, serve

__all__ = ["BatchedChatServer", "serve_batched", "ChatCompletionServer", "serve"]
