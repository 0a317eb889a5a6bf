from .chat import ChatReply, ChatReplyStats, ChatSession, DEFAULT_TOOL_TURN_LIMIT
from .parser import Event, LLAMA_STYLE, QWEN_STYLE, SectionConfig, StreamParser, ToolCall
from .template import ChatTemplate, TemplateError, ToolSpec, validate_messages
from .tokenizer import StreamDecoder, Tokenizer

__all__ = [
    "ChatReply", "ChatReplyStats", "ChatSession", "DEFAULT_TOOL_TURN_LIMIT",
    "Event", "LLAMA_STYLE", "QWEN_STYLE", "SectionConfig", "StreamParser", "ToolCall",
    "ChatTemplate", "TemplateError", "ToolSpec", "validate_messages",
    "StreamDecoder", "Tokenizer",
]
